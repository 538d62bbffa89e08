"""Single dataclass configuration system with CLI overrides.

The reference hard-codes hyper-parameters in module defaults
(reference: mamba_decoder.py:96-105, text_encoder.py:33-45, smsd.py:23-31)
plus ``build_models`` constants (reference: train.py:46-67) and exposes only
seven argparse train flags (reference: train.py:135-143).  Here every
component reads from one typed config tree; the train CLI keeps the same
seven public flags and adds checkpoint/metrics flags the reference lacks.

The PyTorch port keeps its own copy of this module so that one config JSON
loads in both packages.  Fields that select mechanisms of the JAX package
(``use_pallas``, ``scan_chunk``, ``remat``, ``use_sp_scan``, ``sp_axis``,
``use_native_loader``) are kept for that reason; the port's serving path
does not read them.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class MambaConfig:
    """Hyper-parameters of one Mamba (selective-SSM) block.

    Matches the defaults of the ``Mamba(d_model)`` block the reference wraps
    (reference: mamba_decoder.py:29): state dim 16, depthwise causal conv of
    width 4, expansion factor 2, dt_rank = ceil(d_model / 16).
    """

    d_model: int = 512
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    dt_min: float = 1e-3
    dt_max: float = 1e-1
    dt_init_floor: float = 1e-4
    conv_bias: bool = True
    use_bias: bool = False  # in_proj / out_proj bias

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank if self.dt_rank > 0 else -(-self.d_model // 16)


@dataclass(frozen=True)
class DecoderConfig:
    """Mamba TTS decoder stack (reference: mamba_decoder.py:96-105).

    ``vocab_size_audio`` here is the *full* audio-token vocabulary:
    codebook ids are shifted up by ``num_special_tokens`` so that PAD=0 and
    BOS=1 never collide with a real codebook id.  (Fixes reference defect
    where FACodec zero-padding collides with codebook id 0 — reference:
    data_utils/audio_encoder.py:232-241, train.py:184.)
    """

    # Per-codebook id count.  1024 matches the real FACodec codebooks (the
    # reference's vocab_size_audio=10 mistakes upstream's log2 parameter for
    # a count — see CodecConfig.codebook_size).
    codebook_size: int = 1024
    num_special_tokens: int = 2  # PAD=0, BOS=1
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 2048
    d_style: int = 256
    max_len: int = 8192  # flattened multi-quantizer codec sequences
    num_quantizers: int = 5
    mamba: MambaConfig = field(default_factory=MambaConfig)
    dtype: str = "bfloat16"  # compute dtype; params + accumulation are f32
    scan_chunk: int = 64  # time-chunk for the chunked selective scan
    use_pallas: bool = True  # Pallas scan on TPU (falls back to XLA off-TPU)
    remat: bool = False  # jax.checkpoint each decoder layer (activation memory)
    # Sequence/context parallelism: shard the selective scan's TIME axis over
    # mesh axis ``sp_axis`` (parallel/sp_scan.py — the SSM analogue of ring
    # attention).  Requires passing the Mesh when constructing the model
    # (``MambaTTS(cfg, sp_mesh=mesh)``); the flattened token length must
    # divide by the axis size.  Training-path only: decode steps and
    # state-carrying calls use the regular scan.
    use_sp_scan: bool = False
    sp_axis: str = "data"

    pad_id: int = 0
    bos_id: int = 1

    @property
    def vocab_size_audio(self) -> int:
        return self.codebook_size + self.num_special_tokens

    def with_mamba_dims(self) -> "DecoderConfig":
        return dataclasses.replace(
            self, mamba=dataclasses.replace(self.mamba, d_model=self.d_model)
        )


@dataclass(frozen=True)
class TextEncoderConfig:
    """FFT-block text encoder (reference: text_encoder.py:32-45; d_model
    overridden to 512 by reference: train.py:51-54)."""

    vocab_size: int = 79
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 2
    d_k: int = 64
    d_v: int = 64
    d_inner: int = 1024
    conv_kernel: Tuple[int, int] = (9, 1)
    dropout: float = 0.1
    max_seq_len: int = 3000
    padding_idx: int = 0
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class DurationPredictorConfig:
    """FS2-style variance predictor (reference: text_encoder.py:139-168)."""

    d_model: int = 512
    filter_size: int = 256
    kernel_size: int = 3
    dropout: float = 0.1
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class SMSDConfig:
    """Style-Mixture-Semantic-Density module (reference: smsd.py:22-55)."""

    bert_dim: int = 768
    style_dim: int = 256
    num_mixtures: int = 5
    hidden_dim: int = 512
    dropout: float = 0.1
    variance_mode: str = "isotropic_across_clusters"
    noise_scale: float = 0.1
    fixed_std: float = 0.1  # sampling std in "fixed" mode (reference: smsd.py:161)
    fixed_variance: float = 0.01  # NLL variance in "fixed" mode (reference: smsd.py:352)


@dataclass(frozen=True)
class StyleEncoderConfig:
    """Frozen style-text encoder producing (B, 768) [CLS] embeddings.

    The reference uses frozen HF bert-base-uncased (reference: smsd.py:39-45).
    This build ships a self-contained Flax BERT-base (same dims) with a
    torch->flax weight converter; without a checkpoint it runs with
    deterministic random init (capability-parity for pipelines/tests).
    """

    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    max_length: int = 128  # tokenizer truncation (reference: smsd.py:70-76)
    dtype: str = "float32"
    # Path to a real BERT vocab.txt (30,522 lines).  Without one the
    # WordPiece tokenizer falls back to a deterministic hash vocabulary and
    # warns loudly (text/wordpiece.py) — fine for tests/smoke, wrong for
    # training on real data.  Surfaced as --bert_vocab on the train and
    # synthesize CLIs.
    bert_vocab: Optional[str] = None


@dataclass(frozen=True)
class StylePipelineConfig:
    """Style conditioning pipeline (reference: style_cross_attention.py:289-354)."""

    d_style: int = 256
    d_model: int = 512
    num_heads: int = 8
    dropout: float = 0.1
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class CodecConfig:
    """FACodec-compatible neural audio codec.

    Contract (reference: data_utils/audio_encoder.py:140-256): 16 kHz wave ->
    (B, T<=1024, 5) codec ids ordered [Qp, Qr1, Qr2, Qr3, Qc] + (B, 256)
    speaker embedding; hop = prod(up_ratios) = 200 => 80 tokens/s; and the
    inverse tokens -> waveform (the synthesis vocoder path).
    """

    sample_rate: int = 16000
    ngf: int = 32
    up_ratios: Tuple[int, ...] = (2, 4, 5, 5)
    latent_dim: int = 256
    # ACTUAL codes per codebook.  The reference passes codebook_size_*=10,
    # which upstream ns3_codec exponentiates (2**10 = 1024 codes); the
    # reference's own vocab_size_audio=10 (train.py:60-63) treats it
    # literally — a defect.  Pinned to the upstream checkpoint reality.
    codebook_size: int = 1024
    codebook_dim: int = 8
    vq_num_q_p: int = 1
    vq_num_q_c: int = 1  # pinned to the documented 5-stream contract (SURVEY §7.8)
    vq_num_q_r: int = 3
    spk_dim: int = 256
    max_seq_len: int = 1024  # ~12.8 s at 12.5 ms/token
    decoder_initial_channels: int = 1024
    dtype: str = "float32"

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.up_ratios:
            h *= r
        return h

    @property
    def num_quantizers(self) -> int:
        return self.vq_num_q_p + self.vq_num_q_c + self.vq_num_q_r


@dataclass(frozen=True)
class DataConfig:
    csv_path: str = "VccmDataset/controlspeech_train.csv"
    audio_root: str = "TextrolSpeech_data.tar.gz"
    sample_rate: int = 16000
    phoneme_vocab_path: str = "phoneme_vocab.json"
    max_text_len: int = 256  # static padded phoneme length for jit
    use_native_loader: bool = True  # C++ tar/WAV runtime when built


@dataclass(frozen=True)
class TrainConfig:
    """Training loop config. Public flags mirror reference: train.py:135-143."""

    batch_size: int = 10
    lr: float = 1e-4
    max_steps: int = 10
    w_codec: float = 1.0
    w_dur: float = 0.1
    w_smsd: float = 0.5
    grad_clip_norm: float = 1.0
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 100
    log_every: int = 1
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclass(frozen=True)
class TTSConfig:
    """Top-level config tree."""

    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    text_encoder: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    duration: DurationPredictorConfig = field(default_factory=DurationPredictorConfig)
    smsd: SMSDConfig = field(default_factory=SMSDConfig)
    style_encoder: StyleEncoderConfig = field(default_factory=StyleEncoderConfig)
    style: StylePipelineConfig = field(default_factory=StylePipelineConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    return obj


def to_json(cfg: TTSConfig) -> str:
    return json.dumps(_asdict(cfg), indent=2)


def _build(cls, data):
    if not isinstance(data, dict):
        return data
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, str) and f.type in _CONFIG_TYPES
        ):
            sub_cls = _CONFIG_TYPES.get(f.type, f.type) if isinstance(f.type, str) else f.type
            kwargs[f.name] = _build(sub_cls, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_CONFIG_TYPES = {
    c.__name__: c
    for c in (
        MambaConfig,
        DecoderConfig,
        TextEncoderConfig,
        DurationPredictorConfig,
        SMSDConfig,
        StyleEncoderConfig,
        StylePipelineConfig,
        CodecConfig,
        DataConfig,
        TrainConfig,
        TTSConfig,
    )
}


def from_json(text: str) -> TTSConfig:
    return _build(TTSConfig, json.loads(text))


def override(cfg, path: str, value):
    """Override a dotted config path, e.g. ``override(cfg, "train.lr", 3e-4)``."""
    parts = path.split(".")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    child = getattr(cfg, parts[0])
    return dataclasses.replace(cfg, **{parts[0]: override(child, ".".join(parts[1:]), value)})
