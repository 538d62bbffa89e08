"""Weight bridge coverage: every JAX parameter is consumed, every port
parameter is set, and anything else raises.  Trees come from
``jax.eval_shape`` of the JAX package's own inits (shapes only), filled with
seeded numpy values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu import config as jcl
from mamba_tts_tpu.models.facodec import FACodec as JFACodec
from mamba_tts_tpu.models.style_text_encoder import BertEncoder as JBert
from mamba_tts_tpu.train.train import build_model, init_params
from mamba_tts_torch import config as tcl
from mamba_tts_torch.bridge import (
    bert_from_params,
    facodec_from_params,
    load_params,
    mamba_tts_from_params,
)
from mamba_tts_torch.models.facodec import FACodec
from mamba_tts_torch.models.tts import MambaTTS

SMOKE = open("tests/smoke_config.json").read()
J_CFG, T_CFG = jcl.from_json(SMOKE), tcl.from_json(SMOKE)


def _filled(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _mamba_tts_tree():
    model = build_model(J_CFG)
    return _filled(jax.eval_shape(lambda k: init_params(model, J_CFG, k), jax.random.PRNGKey(0)))


def _facodec_tree():
    wav = jnp.zeros((1, 4 * J_CFG.codec.hop_length))
    return _filled(jax.eval_shape(lambda k: JFACodec(J_CFG.codec).init(k, wav),
                                  jax.random.PRNGKey(0))["params"])


def _bert_tree():
    ids, mask = jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), bool)
    return _filled(jax.eval_shape(lambda k: JBert(J_CFG.style_encoder).init(k, ids, mask),
                                  jax.random.PRNGKey(0))["params"])


def _leaves(tree, skip=()):
    return [(jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(tree)
            if not any(jax.tree_util.keystr(p).startswith(f"['{s}']") for s in skip)]


@pytest.mark.parametrize("which", ["mamba_tts", "facodec", "bert"])
def test_every_leaf_consumed_and_every_parameter_set(which):
    if which == "mamba_tts":
        tree, skip = _mamba_tts_tree(), ("style_pipe",)
        module = mamba_tts_from_params(T_CFG, tree)
    elif which == "facodec":
        tree, skip = _facodec_tree(), ()
        module = facodec_from_params(T_CFG.codec, tree)
    else:
        tree, skip = _bert_tree(), ()
        module = bert_from_params(T_CFG.style_encoder, tree)
    leaves = _leaves(tree, skip)
    n_port = sum(p.numel() for p in module.parameters())
    assert n_port == sum(v.size for _, v in leaves)
    assert len(list(module.parameters())) == len(leaves)
    # values land where they should: the sum of every parameter is preserved
    total = sum(float(np.asarray(v, np.float64).sum()) for _, v in leaves)
    got = sum(float(p.detach().double().sum()) for p in module.parameters())
    assert got == pytest.approx(total, rel=1e-9, abs=1e-6)


def test_layouts_of_each_leaf_kind():
    tree = _facodec_tree()
    module = facodec_from_params(T_CFG.codec, tree)
    up = tree["decoder"]["block_0"]["up"]["kernel"]  # (k, in, out), flipped along k
    np.testing.assert_array_equal(module.decoder.block_0.up.weight.detach().numpy(),
                                  up[::-1].transpose(1, 2, 0))
    conv = tree["encoder"]["stem"]["kernel"]  # (k, in, out)
    np.testing.assert_array_equal(module.encoder.stem.weight.detach().numpy(),
                                  conv.transpose(2, 1, 0))
    dense = tree["timbre"]["layer_0"]["q_proj"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(module.timbre.layer_0.q_proj.weight.detach().numpy(), dense.T)
    ln = tree["timbre"]["last_ln"]["scale"]
    np.testing.assert_array_equal(module.timbre.last_ln.weight.detach().numpy(), ln)


def test_unknown_key_raises():
    tree = _facodec_tree()
    tree["encoder"]["stem"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="encoder/stem/extra"):
        load_params(FACodec(T_CFG.codec), tree)
    tree = _facodec_tree()
    tree["no_such_module"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="no_such_module"):
        load_params(FACodec(T_CFG.codec), tree)


def test_missing_key_and_shape_mismatch_raise():
    tree = _facodec_tree()
    del tree["vq_content"]["vq_0"]["codebook"]
    with pytest.raises(ValueError, match="left unset"):
        load_params(FACodec(T_CFG.codec), tree)
    tree = _facodec_tree()
    tree["encoder"]["head"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_params(FACodec(T_CFG.codec), tree)


def test_style_pipe_is_the_only_skipped_subtree():
    tree = _mamba_tts_tree()
    tree["style_pipe_typo"] = tree["style_pipe"]
    with pytest.raises(KeyError):
        mamba_tts_from_params(T_CFG, tree)
    with pytest.raises(KeyError):
        load_params(MambaTTS(T_CFG), _mamba_tts_tree())  # style_pipe without the skip


def test_bridge_imports_no_jax():
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    for path in [*(root / "mamba_tts_torch").rglob("*.py"), root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "flax", "mamba_tts_tpu"), (path, n)
    assert torch.is_tensor(torch.zeros(1))
