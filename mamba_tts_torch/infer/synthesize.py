"""Synthesis entry point: text + style prompt + voice prompt -> waveform —
counterpart of ``mamba_tts_tpu/infer/synthesize.py``.

    text --G2P--> phonemes --TextEncoder--> text_hidden
    style prompt --BERT--> SMSD sample --> z_style
    voice prompt --FACodec encode--> ref tokens --embed--> ref_hidden
    duration predictor --> frame budget (64-frame buckets)
    autoregressive decode over Q * frames tokens (step loop or megakernel)
    codec ids --FACodec decode--> waveform

``quant`` selects the decode of the MAVE decoder: "none" (full-precision step), "int8" (the
large per-step products through the Hopper ``int8_matvec`` kernel),
"int8_kv" (int8 weights and int8 cross-attention K/V) or "megakernel" (the
whole decode in one launch of the Hopper kernel of
``ops/decode_megakernel.py``, greedy or Gumbel-max sampled, with the
weight/K-V dtypes chosen per batch and memory length by its planner; a
batch the planner finds no fit for takes the int8 step decode).  The jamba
and granite decoders (``DecoderConfig.block`` ``"jamba"``, ``"granite"``)
take ``quant="none"`` only: a prefill of each row's prefix, then the
captured decode (``models/hybrid.py`` ``hybrid_greedy_decode``).
:func:`load_synthesizer` serves the newest checkpoint of the port's train
CLI (configured by the ``config.json`` beside it) and the released FACodec
state dicts from local paths.

``mesh`` (a ``DeviceMesh`` with a "data" axis, ``parallel/mesh.py``) serves
batches data-parallel, SPMD: every rank calls with the same requests and
holds the same weights; ``synthesize_batch`` pads the rows to a multiple of
the axis by repeating the last row, each rank decodes its contiguous rows
(the megakernel's fit and chunk per rank), the token rows are all-gathered
and trimmed, and every rank finishes as one device does.  Sampled decodes
and the style draw take one stream per rank (the same distribution as the
single-device path, other numbers).  A single utterance stays on one rank's
path:

    torchrun --nproc_per_node 2 -m mamba_tts_torch.infer.synthesize \
        --texts_file texts.txt --voice_wav prompt.wav --dp_serving

Runs on the CUDA card unless ``device="cpu"`` is passed; with no card it
raises rather than falling back.

CLI:
    python -m mamba_tts_torch.infer.synthesize --text "hello world" \\
        --style_prompt "speak fast" --voice_wav prompt.wav --output out.wav \\
        [--checkpoint_dir checkpoints] [--quant megakernel] [--device cuda]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from mamba_tts_torch import config as config_lib
from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.config import TTSConfig
from mamba_tts_torch.device import resolve_device
from mamba_tts_torch.infer.quant_decode import greedy_decode_int8, quantize_decoder_params
from mamba_tts_torch.models.decoder import greedy_decode
from mamba_tts_torch.models.hybrid import hybrid_greedy_decode
from mamba_tts_torch.models.layers import hold_in_compute_dtype, seed_init
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.ops.decode_megakernel import (
    build_weight_plan,
    megakernel_fit,
    megakernel_greedy_decode,
    megakernel_max_batch,
)
from mamba_tts_torch.parallel import comm
from mamba_tts_torch.parallel.distributed import rank_mesh
from mamba_tts_torch.parallel.mesh import axis_group, axis_rank, axis_size
from mamba_tts_torch.text.processor import PhonemeFrontend
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.utils.profiling import annotate

_RANK_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: (request seed, rank) -> a rank's stream


def _run_chunked(run, arrays, generator, chunk):
    """Call ``run(*arrays, generator)`` in row chunks of at most ``chunk``
    and concatenate the results along the rows.  The chunks run one after
    the other and draw from ``generator`` in turn.  ``chunk=None`` (or a
    batch within it) runs the batch whole."""
    B = arrays[0].shape[0]
    if chunk is None or B <= chunk:
        return run(*arrays, generator)
    return torch.cat([run(*(a[lo:lo + chunk] for a in arrays), generator)
                      for lo in range(0, B, chunk)], dim=0)


def _megakernel_dtypes(cfg, batch: int, memory_len: int, sampled: bool = False,
                       budget_bytes: Optional[int] = None):
    """(weight_dtype, kv_dtype) for a megakernel call at this batch and
    cross-attention memory length, or None to take the int8 step decode
    (``ops.decode_megakernel.megakernel_fit``)."""
    return megakernel_fit(cfg, batch, memory_len, sampled=sampled, budget_bytes=budget_bytes)


def _tensor_parallel(decoder) -> bool:
    """Whether ``decoder`` was built on a mesh that splits its layers over a
    tensor-parallel group."""
    return any(getattr(m, "tp_group", None) is not None for m in decoder.modules())


class Synthesizer:
    """End-to-end TTS inference engine over a :class:`MambaTTS` module.

    It holds the decoder as served.  With ``quant="none"`` every ``Dense``
    weight and bias of the decoder that is wider than its compute dtype is
    stored in that dtype once, at build, and the float32 storage released
    (``layers.hold_in_compute_dtype``): the decode step's products read them
    in place and cast nothing.  The int8, int8_kv and megakernel paths
    quantize and stack the float32 masters, and a decoder split over a
    tensor-parallel group adds its float32 bias after the float32 reduce,
    so those keep their masters.  A model passed in is changed in place, as
    ``.to(device).eval()`` already changes it."""

    def __init__(
        self,
        cfg: TTSConfig,
        model: MambaTTS,
        tokenizer: Optional[FACodecTokenizer] = None,
        frontend: Optional[PhonemeFrontend] = None,
        style_encoder: Optional[StyleTextEncoder] = None,
        quant: str = "none",
        mesh=None,
        device="cuda",
    ):
        if quant not in ("none", "int8", "int8_kv", "megakernel"):
            raise ValueError(f"quant must be none|int8|int8_kv|megakernel, got {quant!r}")
        if cfg.decoder.hybrid and quant != "none":
            raise ValueError(f"the {cfg.decoder.block} decoder decodes through its captured "
                             f"bf16 path only (quant='none'), not quant={quant!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.quant = quant
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.decoder = self.model.decoder
        if quant == "none" and not _tensor_parallel(self.decoder):
            hold_in_compute_dtype(self.decoder)
        self._qparams = quantize_decoder_params(self.decoder) if quant != "none" else None
        # one weight plan per weight dtype the planner can pick, built once, so
        # that a decode call stacks, casts and folds no weights
        self._weight_plans = None
        if quant == "megakernel":
            self._weight_plans = {wd: build_weight_plan(self.decoder.cfg, self._qparams, wd)
                                  for wd in ("bfloat16", "int8")}
        self.tokenizer = tokenizer or FACodecTokenizer(cfg.codec, device=self.device)
        self.frontend = frontend or PhonemeFrontend(vocab_path=cfg.data.phoneme_vocab_path)
        self.style_encoder = style_encoder or StyleTextEncoder(cfg.style_encoder, device=self.device)
        self._voice_cache = {}  # name -> (codec (max_seq, Q), true frames)

    # ------------------------------------------------------------- pipeline

    def _tensors(self, phoneme_ids, text_mask, voice_codec):
        dev = self.device
        return (torch.as_tensor(phoneme_ids, dtype=torch.long, device=dev),
                torch.as_tensor(text_mask, dtype=torch.bool, device=dev),
                torch.as_tensor(voice_codec, dtype=torch.long, device=dev))

    @torch.no_grad()
    def decode_tokens(self, phoneme_ids, text_mask, style_bert, voice_codec, frames: int,
                      temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Condition and decode rows at one frame budget; (B, Q*frames)
        token ids on the device.  ``generator`` draws the style sample and,
        when ``temperature > 0``, the tokens."""
        model = self.model
        with annotate("synth.condition"):
            text_hidden = model.encode_text(phoneme_ids, text_mask)
            z_style = model.sample_style(style_bert, generator)
            ref_hidden, ref_mask = model.embed_voice(voice_codec)
        kw = dict(text_mask=text_mask, ref_hidden=ref_hidden, ref_mask=ref_mask,
                  temperature=temperature, generator=generator)
        mega = None
        if self.quant == "megakernel":
            with annotate("decode.plan"):
                mega = _megakernel_dtypes(
                    self.decoder.cfg, phoneme_ids.shape[0],
                    ref_hidden.shape[1] + text_hidden.shape[1], sampled=temperature > 0)
        if self.decoder.cfg.hybrid:
            res = hybrid_greedy_decode(self.decoder, text_hidden, z_style, frames, **kw)
        elif self.quant == "none":
            res = greedy_decode(self.decoder, text_hidden, z_style, frames, **kw)
        elif mega is not None:
            res = megakernel_greedy_decode(
                self.decoder, self._qparams, text_hidden, z_style, frames,
                weight_dtype=mega[0], kv_dtype=mega[1], weight_plan=self._weight_plans[mega[0]],
                **kw)
        else:
            res = greedy_decode_int8(self.decoder, self._qparams, text_hidden, z_style, frames,
                                     int8_kv=self.quant == "int8_kv", **kw)
        return res.tokens

    def register_voice(self, name: str, voice_wav) -> None:
        """Encode a voice prompt once and cache its codec grid under
        ``name``; ``synthesize``/``synthesize_batch`` then accept the name in
        place of the waveform and skip the FACodec encode."""
        codec, _, lens = self.tokenizer.encode_with_lengths([voice_wav])
        self._voice_cache[name] = (np.asarray(codec[0]), int(lens[0]))

    def _encode_voice(self, voice_wavs) -> np.ndarray:
        """Tokenize voice prompts (waveforms, paths or registered names) and
        trim the codec grid to a 64-frame bucket of the longest true prompt.
        Identical waveform objects (and equal paths) encode once."""
        rows: list = [None] * len(voice_wavs)
        lens: list = [0] * len(voice_wavs)
        fresh, fresh_idx, seen = [], [], {}
        for i, v in enumerate(voice_wavs):
            if isinstance(v, str) and v in self._voice_cache:
                rows[i], lens[i] = self._voice_cache[v]
                continue
            key = v if isinstance(v, str) else id(v)
            if key in seen:
                rows[i] = seen[key]  # backreference, filled after encode
            else:
                seen[key] = i
                fresh.append(v)
                fresh_idx.append(i)
        if fresh:
            with annotate("synth.voice_encode", rows=len(fresh)):
                codec, _, fresh_lens = self.tokenizer.encode_with_lengths(fresh)
            for j, i in enumerate(fresh_idx):
                rows[i] = np.asarray(codec[j])
                lens[i] = int(fresh_lens[j])
        for i, r in enumerate(rows):
            if isinstance(r, int):
                rows[i], lens[i] = rows[r], lens[r]
        S = int(min(self.cfg.codec.max_seq_len, -(-max(8, max(lens)) // 64) * 64))
        return np.stack([r[:S] for r in rows])

    @torch.no_grad()
    def predict_frames_per_utterance(self, phoneme_ids, text_mask) -> np.ndarray:
        """(B,) frame budgets: sum of exp(log_dur) over valid phonemes."""
        ids = torch.as_tensor(phoneme_ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(text_mask, dtype=torch.bool, device=self.device)
        log_dur = self.model.predict_durations(self.model.encode_text(ids, mask), mask)
        frames = (torch.exp(log_dur) * mask.to(log_dur.dtype)).sum(dim=1).cpu().numpy()
        return np.clip(frames, 8, self.cfg.codec.max_seq_len).astype(np.int64)

    def predict_frames(self, phoneme_ids, text_mask) -> int:
        return int(self.predict_frames_per_utterance(phoneme_ids, text_mask).max())

    def _bucket(self, frames) -> int:
        return int(min(-(-int(frames) // 64) * 64, self.cfg.codec.max_seq_len))

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @annotate("synth.decode")
    def _decode_rows(self, arrays, frames: int, temperature: float, generator) -> np.ndarray:
        """Decode rows at one frame budget; (B, Q*frames) tokens on the host.
        The megakernel takes at most ``megakernel_max_batch`` rows at this
        memory length (voice-codec tokens + text tokens) per call, so a
        bigger batch runs as consecutive chunks; 0 runs the batch whole, and
        ``decode_tokens`` then takes the int8 step decode by the same fit.
        On a mesh, a batch of more than one row is split over the "data"
        ranks (padded by repeating its last row), each rank decodes its
        contiguous rows with its own stream, and the rows are gathered."""
        chunk = None
        if self.quant == "megakernel":
            Q = self.cfg.decoder.num_quantizers
            memory_len = arrays[3].shape[1] * Q + arrays[0].shape[1]
            chunk = megakernel_max_batch(self.decoder.cfg, memory_len,
                                         sampled=temperature > 0) or None

        def run(ids, mask, style, voice, gen):
            return self.decode_tokens(ids, mask, style, voice, frames, temperature, gen)

        B, n = arrays[0].shape[0], axis_size(self.mesh, "data")
        if B == 1 or n == 1:
            return _run_chunked(run, arrays, generator, chunk).cpu().numpy()
        per = -(-B // n)
        arrays = [torch.cat([a, a[-1:].expand(n * per - B, *a.shape[1:])]) for a in arrays]
        rank = axis_rank(self.mesh, "data")
        mine = [a[rank * per:(rank + 1) * per] for a in arrays]
        # one draw from the request's stream (the same on every rank) seeds
        # this rank's stream
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        gen = self._generator((base + rank * _RANK_MIX) % 2 ** 63)
        tokens = _run_chunked(run, mine, gen, chunk)
        return comm.gather(tokens, 0, axis_group(self.mesh, "data"))[:B].cpu().numpy()

    def _front(self, texts, style_prompts, voice_wavs):
        """G2P, BERT and the voice encode of a request's rows: ((phoneme ids,
        text mask, style BERT, voice codec) on the device, the host phoneme
        ids, the host text mask)."""
        with annotate("synth.g2p"):
            phoneme_ids, _, text_mask = self.frontend.encode_batch(
                list(texts), pad_to=self.cfg.data.max_text_len)
        with annotate("synth.bert"):
            style_bert = self.style_encoder.embed(list(style_prompts))
        voice_codec = self._encode_voice(list(voice_wavs))
        ids, mask, voice = self._tensors(phoneme_ids, text_mask, voice_codec)
        return (ids, mask, style_bert, voice), phoneme_ids, text_mask

    def _decode_bucket(self, arrays, frames: int, temperature: float, generator) -> np.ndarray:
        """Decode rows at one frame budget, then FACodec: (B, frames * hop)
        waveforms."""
        tokens = self._decode_rows(arrays, frames, temperature, generator)
        Q = self.cfg.decoder.num_quantizers
        codec = tokens.reshape(len(tokens), Q, frames).transpose(0, 2, 1)
        with annotate("synth.codec_decode"):
            return self.tokenizer.decode(codec)

    def _synthesize_fixed(self, texts, style_prompts, voice_wavs, frames: Optional[int],
                          temperature: float, seed: int) -> Tuple[np.ndarray, int]:
        """A fixed-length request: every row decodes at one 64-frame bucket,
        of ``frames`` or else of the longest predicted duration.  Returns
        ((B, T_audio) waveforms, the bucket)."""
        arrays, phoneme_ids, text_mask = self._front(texts, style_prompts, voice_wavs)
        if frames is None:
            with annotate("synth.durations"):
                frames = self.predict_frames(phoneme_ids, text_mask)
        frames = self._bucket(frames)
        return self._decode_bucket(arrays, frames, temperature, self._generator(seed)), frames

    @annotate("synth.request")
    def synthesize(self, text: str, style_prompt: str, voice_wav, frames: Optional[int] = None,
                   temperature: float = 0.0, seed: int = 0) -> Tuple[np.ndarray, dict]:
        """Returns (waveform (T,) float32 at 16 kHz, info).  ``voice_wav`` is
        a waveform array, a WAV path or a :meth:`register_voice` name."""
        t0 = time.perf_counter()
        wavs, frames = self._synthesize_fixed([text], [style_prompt], [voice_wav], frames,
                                              temperature, seed)
        wall = time.perf_counter() - t0
        audio_seconds = frames / self.tokenizer.frames_per_second
        info = {
            "frames": frames,
            "tokens": int(self.cfg.decoder.num_quantizers * frames),
            "audio_seconds": audio_seconds,
            "wall_seconds": wall,
            "rtf": wall / audio_seconds,
        }
        return wavs[0], info

    @annotate("synth.request")
    def synthesize_batch(self, texts, style_prompts, voice_wavs, frames: Optional[int] = None,
                         temperature: float = 0.0, seed: int = 0,
                         variable_length: bool = False):
        """Batched serving: lists of (text, style, voice prompt).

        ``variable_length=False``: every row decodes at the batch-max frame
        bucket; returns (B, T_audio) stacked waveforms.  ``True``: rows group
        by their own 64-frame duration bucket and each group decodes at its
        own budget; returns a list of waveforms trimmed to their predicted
        frames (capped at ``frames`` when given, which then fixes one
        bucket)."""
        if not len(texts) == len(style_prompts) == len(voice_wavs):
            raise ValueError("texts, style_prompts and voice_wavs differ in length")
        t0 = time.perf_counter()
        B = len(texts)
        Q = self.cfg.decoder.num_quantizers
        if not variable_length:
            wavs, frames = self._synthesize_fixed(texts, style_prompts, voice_wavs, frames,
                                                  temperature, seed)
            wall = time.perf_counter() - t0
            info = {
                "frames": frames,
                "tokens": int(B * Q * frames),
                "audio_seconds": frames / self.tokenizer.frames_per_second,
                "wall_seconds": wall,
                "tokens_per_sec": B * Q * frames / wall,
            }
            return wavs, info

        arrays, phoneme_ids, text_mask = self._front(texts, style_prompts, voice_wavs)
        generator = self._generator(seed)
        with annotate("synth.durations"):
            per_utt = self.predict_frames_per_utterance(phoneme_ids, text_mask)
        if frames is not None:
            per_utt = np.minimum(per_utt, int(frames))
            buckets = np.full(B, self._bucket(frames))
        else:
            buckets = np.array([self._bucket(f) for f in per_utt])
        wavs: list = [None] * B
        total_tokens = 0
        for bucket in sorted(set(buckets.tolist())):
            idx = np.nonzero(buckets == bucket)[0]
            sel = torch.as_tensor(idx, device=self.device)
            group_wavs = self._decode_bucket(tuple(a[sel] for a in arrays), bucket, temperature,
                                             generator)
            for row, i in enumerate(idx):
                wavs[int(i)] = group_wavs[row][: int(per_utt[i]) * self.tokenizer.hop]
            total_tokens += len(idx) * Q * bucket
        wall = time.perf_counter() - t0
        info = {
            "frames": [int(f) for f in per_utt],
            "buckets": buckets.tolist(),
            "tokens": total_tokens,
            "audio_seconds": [int(f) / self.tokenizer.frames_per_second for f in per_utt],
            "wall_seconds": wall,
            "tokens_per_sec": total_tokens / wall,
        }
        return wavs, info


def checkpoint_config(checkpoint_dir: Optional[str]) -> Optional[TTSConfig]:
    """The config that the train CLI wrote beside its checkpoints
    (``<checkpoint_dir>/config.json``), or None."""
    path = Path(checkpoint_dir) / "config.json" if checkpoint_dir is not None else None
    return config_lib.from_json(path.read_text()) if path and path.is_file() else None


def load_synthesizer(cfg: Optional[TTSConfig] = None, checkpoint_dir: Optional[str] = None,
                     seed: int = 0, codec_ckpts=None, quant: str = "none", mesh=None,
                     device="cuda") -> Synthesizer:
    """A :class:`Synthesizer` over the newest checkpoint of the port's train
    CLI in ``checkpoint_dir`` (``<step>/state.pt``), or at a seeded random
    init (``seed``) when there is none, as the JAX package does.  With
    ``cfg`` None the model configures itself from the ``config.json``
    beside the checkpoints.  A checkpoint whose keys or shapes differ from
    the model raises.  ``codec_ckpts`` = (encoder, decoder) local paths of
    the released FACodec state dicts; without them FACodec, like BERT, is at
    a seeded init (seed 0).  ``mesh``: serve batches data-parallel over
    its "data" axis (every rank loads the same weights)."""
    if cfg is None:
        cfg = checkpoint_config(checkpoint_dir) or TTSConfig()
    dev = resolve_device(device)
    model = MambaTTS(cfg)
    params, restored = (state_lib.restore_params(checkpoint_dir) if checkpoint_dir is not None
                        else (None, False))
    if restored:
        state_lib.copy_params(dict(model.named_parameters()), params)
    else:
        seed_init(model, seed)
    tokenizer = None
    if codec_ckpts:
        tokenizer = FACodecTokenizer(cfg.codec, device=dev, torch_encoder_ckpt=codec_ckpts[0],
                                     torch_decoder_ckpt=codec_ckpts[1])
    return Synthesizer(cfg, model, tokenizer=tokenizer, quant=quant, mesh=mesh, device=dev)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--text", type=str, default=None,
                        help="single-utterance mode (or use --texts_file)")
    parser.add_argument("--style_prompt", type=str, default="speak in a neutral voice")
    parser.add_argument("--voice_wav", type=str, required=True)
    parser.add_argument("--output", type=str, default="synthesized.wav")
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--config_json", type=str, default=None)
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--facodec_encoder_ckpt", type=str, default=None)
    parser.add_argument("--facodec_decoder_ckpt", type=str, default=None)
    parser.add_argument("--quant", type=str, default="none",
                        choices=("none", "int8", "int8_kv", "megakernel"),
                        help="decode numerics (int8 weight streaming through the "
                             "Hopper int8_matvec kernel; int8_kv also int8 K/V; "
                             "megakernel = the whole decode in one kernel launch)")
    parser.add_argument("--texts_file", type=str, default=None,
                        help="batch mode: one text per line (style/voice prompts "
                             "shared); writes <output-stem>_NNN.wav per line")
    parser.add_argument("--variable_length", action="store_true",
                        help="batch mode: group rows by their own 64-frame bucket")
    parser.add_argument("--dp_serving", action="store_true",
                        help="shard batch rows over every rank of the process group "
                             "(torchrun; one process a rank) on a 'data' mesh")
    parser.add_argument("--bert_vocab", type=str, default=None,
                        help="path to a real BERT vocab.txt for the style-text encoder")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the CUDA card (default) or the CPU")
    args = parser.parse_args(argv)
    if args.text is None and not args.texts_file:
        parser.error("one of --text or --texts_file is required")

    from mamba_tts_torch.audio.wavio import write_wav

    cfg = (config_lib.from_json(open(args.config_json).read()) if args.config_json
           else checkpoint_config(args.checkpoint_dir) or TTSConfig())
    if args.bert_vocab:
        cfg = config_lib.override(cfg, "style_encoder.bert_vocab", args.bert_vocab)
    ckpts = ((args.facodec_encoder_ckpt, args.facodec_decoder_ckpt)
             if args.facodec_encoder_ckpt else None)
    mesh = rank_mesh(None, ("data",), resolve_device(args.device)) if args.dp_serving else None
    main_rank = mesh is None or mesh.get_rank() == 0
    synth = load_synthesizer(cfg, args.checkpoint_dir, args.seed, codec_ckpts=ckpts,
                             quant=args.quant, mesh=mesh, device=args.device)
    if args.texts_file:
        texts = [ln.strip() for ln in open(args.texts_file) if ln.strip()]
        B = len(texts)
        wavs, info = synth.synthesize_batch(
            texts, [args.style_prompt] * B, [args.voice_wav] * B, frames=args.frames,
            temperature=args.temperature, seed=args.seed, variable_length=args.variable_length)
        if not main_rank:
            return
        stem = args.output[:-4] if args.output.endswith(".wav") else args.output
        for i, w in enumerate(wavs):
            write_wav(f"{stem}_{i:03d}.wav", np.asarray(w), cfg.codec.sample_rate)
        print(info)
        print(f"wrote {B} wavs to {stem}_*.wav"
              + (f" (data-parallel over {mesh.size()} ranks)" if mesh is not None else ""))
        return
    wav, info = synth.synthesize(args.text, args.style_prompt, args.voice_wav,
                                 frames=args.frames, temperature=args.temperature,
                                 seed=args.seed)
    if not main_rank:
        return
    write_wav(args.output, wav, cfg.codec.sample_rate)
    print(info)
    print(f"wrote {args.output}: {info['audio_seconds']:.2f}s audio, RTF {info['rtf']:.3f}")


if __name__ == "__main__":
    main()
