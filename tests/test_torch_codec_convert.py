"""The released FACodec and BERT state dicts into the port, without any
release file: the port's converters (``models/facodec.py``
``convert_torch_facodec``, ``models/style_text_encoder.py``
``convert_torch_bert_state_dict``) against the JAX package's, leaf for leaf
(the same numpy arithmetic, so exactly); every key of the pinned inventories
(``tests/data/*_manifest.json``) read at its recorded shape and loaded by
the bridge; FACodec's forward against the upstream-graph torch replicas of
``tests/test_facodec_convert.py``; and the loading entry points
(``FACodecTokenizer(torch_*_ckpt=...)``, ``StyleTextEncoder(checkpoint=...)``,
``load_synthesizer(codec_ckpts=...)``)."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import test_facodec_convert as tfc
from mamba_tts_tpu.config import StyleEncoderConfig as JStyleEncoderConfig
from mamba_tts_tpu.models import facodec as jfc
from mamba_tts_tpu.models import style_text_encoder as jste
from mamba_tts_torch import config as tcl
from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.bridge import bert_from_params, facodec_from_params
from mamba_tts_torch.infer.synthesize import load_synthesizer
from mamba_tts_torch.models import facodec as tfacodec
from mamba_tts_torch.models import style_text_encoder as tste

WAV_TOL = 5e-4  # tests/test_torch_frontends.py
BERT_BASE = dict(vocab_size=30522, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
                 max_position=512, type_vocab_size=2)
SMALL_BERT = dict(vocab_size=300, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_position=40,
                  type_vocab_size=2, max_length=16)
T_CODEC = tcl.CodecConfig(**dataclasses.asdict(tfc.CFG))


def _manifest(name):
    return json.load(open(f"tests/data/{name}_manifest.json"))


class _Reads(dict):
    """A state dict that records which keys were read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _zeros(manifest):
    return _Reads({k: np.zeros(shape, np.float32) for k, shape in manifest.items()})


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _replicas(seed):
    torch.manual_seed(seed)
    return tfc.TEncoder(tfc.CFG).eval(), tfc.TDecoder(tfc.CFG).eval()


def _tame(*modules):
    """Halve every kernel of the replicas (the weight-norm gains, Linear and
    attention weights; not the LayerNorm scales or the codebooks), as
    ``tame_codec_params`` does to a Flax tree: a well-conditioned waveform."""
    with torch.no_grad():
        for m in modules:
            for name, p in m.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("weight_g", "in_proj_weight") or (
                        leaf == "weight" and "codebook" not in name and "ln" not in name):
                    p.mul_(0.5)


# ------------------------------------------------------------------ FACodec


def test_facodec_manifest_is_read_and_loaded_at_its_shapes():
    """Every key of the released inventory is read, and the tree loads into
    the port's FACodec at released scale (the bridge checks every leaf)."""
    man = _manifest("facodec_consumed")
    enc, dec = _zeros(man["encoder"]), _zeros(man["decoder"])
    tree = tfacodec.convert_torch_facodec(enc, dec, tcl.CodecConfig())
    assert enc.read == set(man["encoder"]) and dec.read == set(man["decoder"])
    codec = facodec_from_params(tcl.CodecConfig(), tree)
    assert sum(p.numel() for p in codec.parameters()) == sum(v.size for v in _leaves(tree).values())


def test_facodec_converter_equals_jax_converter():
    enc, dec = _replicas(0)
    want = jfc.convert_torch_facodec(enc.state_dict(), dec.state_dict(), tfc.CFG)
    got = tfacodec.convert_torch_facodec(enc.state_dict(), dec.state_dict(), T_CODEC)
    _assert_trees_equal(got, want)
    g, v = enc.state_dict()["block.0.weight_g"], enc.state_dict()["block.0.weight_v"]
    fused = (g * v / v.norm(dim=(1, 2), keepdim=True)).numpy()  # g * v / ||v||
    np.testing.assert_allclose(got["encoder"]["stem"]["kernel"], fused.transpose(2, 1, 0),
                               rtol=1e-6, atol=1e-7)


@torch.no_grad()
def test_facodec_forward_matches_the_upstream_graph():
    """Waveform -> ids and speaker embedding -> waveform, the port's FACodec
    on converted weights against the torch replicas of the upstream graph."""
    enc, dec = _replicas(1)
    _tame(enc, dec)
    codec = facodec_from_params(T_CODEC, tfacodec.convert_torch_facodec(
        enc.state_dict(), dec.state_dict(), T_CODEC)).eval()
    wav = torch.from_numpy(np.random.RandomState(1).randn(2, 128).astype(np.float32) * 0.3)
    recon_t, ids_t, spk_t = dec(enc(wav[:, None, :]))
    ids, spk = codec.encode(wav)
    np.testing.assert_array_equal(ids.numpy(), ids_t.numpy())
    np.testing.assert_allclose(spk.numpy(), spk_t.numpy(), atol=2e-4)
    np.testing.assert_allclose(codec.decode(ids, spk).numpy(), recon_t[:, 0].numpy(),
                               atol=WAV_TOL)


@pytest.mark.parametrize("where", ["encoder", "decoder"])
def test_facodec_shape_drift_raises(where):
    man = _manifest("facodec_consumed")
    enc, dec = _zeros(man["encoder"]), _zeros(man["decoder"])
    if where == "encoder":
        enc["block.0.weight_v"] = np.zeros((32, 1, 5), np.float32)  # wrong taps
    else:
        dec["quantizer.1.quantizers.0.codebook.weight"] = np.zeros((1024, 4), np.float32)
    tree = tfacodec.convert_torch_facodec(enc, dec, tcl.CodecConfig())
    with pytest.raises(ValueError, match="shape mismatch"):
        facodec_from_params(tcl.CodecConfig(), tree)


def test_facodec_files_load_through_the_tokenizer(tmp_path):
    enc, dec = _replicas(2)
    ep, dp = tmp_path / "ns3_facodec_encoder.bin", tmp_path / "ns3_facodec_decoder.bin"
    torch.save(enc.state_dict(), ep)
    torch.save(dec.state_dict(), dp)
    tok = FACodecTokenizer(T_CODEC, device="cpu", torch_encoder_ckpt=str(ep),
                           torch_decoder_ckpt=str(dp))
    want = facodec_from_params(T_CODEC, jfc.load_torch_facodec(str(ep), str(dp), tfc.CFG))
    for (n, p), (_, q) in zip(tok.module.named_parameters(), want.named_parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(FileNotFoundError) as err:
        FACodecTokenizer(T_CODEC, device="cpu", torch_encoder_ckpt=str(ep),
                         torch_decoder_ckpt=str(tmp_path / "missing.bin"))
    assert "missing.bin" in str(err.value) and "ownload" not in str(err.value)
    with pytest.raises(ValueError, match="both"):
        FACodecTokenizer(T_CODEC, device="cpu", torch_encoder_ckpt=str(ep))


def test_load_synthesizer_takes_codec_checkpoints(tmp_path):
    cfg = tcl.from_json(open("tests/smoke_config.json").read())  # spk_dim == latent_dim
    torch.manual_seed(3)
    enc, dec = tfc.TEncoder(cfg.codec), tfc.TDecoder(cfg.codec)
    ep, dp = tmp_path / "enc.bin", tmp_path / "dec.bin"
    torch.save(enc.state_dict(), ep)
    torch.save(dec.state_dict(), dp)
    synth = load_synthesizer(cfg, codec_ckpts=(str(ep), str(dp)), device="cpu")
    np.testing.assert_array_equal(
        synth.tokenizer.module.decoder.timbre_linear.weight.detach().numpy(),
        dec.state_dict()["timbre_linear.weight"].numpy())


# --------------------------------------------------------------------- BERT


def _bert_sd(c, rng, raw):
    """A HF BERT state dict at config ``c`` with seeded values, in the raw
    ``pytorch_model.bin`` naming (``bert.`` prefix, LayerNorm gamma/beta,
    the MLM head) or the ``BertModel.state_dict()`` one."""
    d, ff = c["d_model"], c["d_ff"]
    pre = "bert." if raw else ""
    gb = ("gamma", "beta") if raw else ("weight", "bias")
    shapes = {"embeddings.word_embeddings.weight": (c["vocab_size"], d),
              "embeddings.position_embeddings.weight": (c["max_position"], d),
              "embeddings.token_type_embeddings.weight": (c["type_vocab_size"], d),
              "pooler.dense.weight": (d, d), "pooler.dense.bias": (d,)}

    def ln(prefix):
        shapes.update({f"{prefix}.LayerNorm.{gb[0]}": (d,), f"{prefix}.LayerNorm.{gb[1]}": (d,)})

    ln("embeddings")
    for i in range(c["n_layers"]):
        e = f"encoder.layer.{i}"
        for name, shape in ((f"{e}.attention.self.query", (d, d)), (f"{e}.attention.self.key", (d, d)),
                            (f"{e}.attention.self.value", (d, d)),
                            (f"{e}.attention.output.dense", (d, d)),
                            (f"{e}.intermediate.dense", (ff, d)), (f"{e}.output.dense", (d, ff))):
            shapes.update({f"{name}.weight": shape, f"{name}.bias": shape[:1]})
        ln(f"{e}.attention.output")
        ln(f"{e}.output")
    sd = {pre + k: (0.05 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    if raw:
        sd["cls.predictions.bias"] = np.zeros(c["vocab_size"], np.float32)
    return sd


@pytest.mark.parametrize("variant", ["raw_bin", "bertmodel_statedict"])
def test_bert_manifest_is_read_and_loaded_at_its_shapes(variant):
    man = _manifest("bert_base_uncased")[variant]
    cfg = tcl.StyleEncoderConfig(**BERT_BASE)
    tree = tste.convert_torch_bert_state_dict(_zeros(man), cfg)
    # one leaf per key, apart from the pretraining heads and the pooler
    read = [k for k in man if not k.startswith(("cls.", "pooler.", "bert.pooler."))]
    leaves = _leaves(tree)
    assert len(leaves) == len(read)
    assert sum(v.size for v in leaves.values()) == sum(int(np.prod(man[k])) for k in read)
    bert = bert_from_params(cfg, tree)
    assert sum(p.numel() for p in bert.parameters()) == sum(v.size for v in leaves.values())


def test_bert_converter_equals_jax_converter_in_both_namings():
    rng = np.random.default_rng(0)
    raw = _bert_sd(SMALL_BERT, rng, raw=True)
    plain = {k[len("bert."):].replace("LayerNorm.gamma", "LayerNorm.weight")
             .replace("LayerNorm.beta", "LayerNorm.bias"): v
             for k, v in raw.items() if k.startswith("bert.")}
    jcfg, tcfg = JStyleEncoderConfig(**SMALL_BERT), tcl.StyleEncoderConfig(**SMALL_BERT)
    want = jste.convert_torch_bert_state_dict(raw, jcfg)
    for sd in (raw, plain, {k: torch.from_numpy(v) for k, v in plain.items()}):
        _assert_trees_equal(tste.convert_torch_bert_state_dict(sd, tcfg), want)


@torch.no_grad()
def test_style_text_encoder_takes_a_checkpoint():
    """``StyleTextEncoder(checkpoint=...)`` from a torch state dict and from
    a converted tree gives JAX's embeddings (1e-4,
    tests/test_torch_frontends.py); a drifted shape raises."""
    sd = {k: torch.from_numpy(v) for k, v in _bert_sd(SMALL_BERT, np.random.default_rng(1),
                                                       raw=False).items()}
    jcfg, tcfg = JStyleEncoderConfig(**SMALL_BERT), tcl.StyleEncoderConfig(**SMALL_BERT)
    texts = ["speak fast", "a calm low voice, please"]
    want = np.asarray(jste.StyleTextEncoder(jcfg, checkpoint=sd).embed(texts))
    for ck in (sd, tste.convert_torch_bert_state_dict(sd, tcfg)):
        got = tste.StyleTextEncoder(tcfg, checkpoint=ck, device="cpu").embed(texts)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    sd["encoder.layer.1.intermediate.dense.weight"] = torch.zeros(64, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        tste.StyleTextEncoder(tcfg, checkpoint=sd, device="cpu")
