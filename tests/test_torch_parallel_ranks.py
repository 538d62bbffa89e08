"""Rank programs of ``tests/test_torch_parallel.py``.

Each function runs in every rank of a world that
``mamba_tts_torch.parallel.dryrun.spawn`` starts (gloo on the CPU), so the
ranks import this module by name: it imports no jax.  Each world runs
several checks and returns their results; the test process holds them to
the JAX package and to the single-rank port.  No test is collected here.
"""
import numpy as np
import torch
import torch.distributed as dist

from mamba_tts_torch import config as config_lib
from mamba_tts_torch.bridge import load_params
from mamba_tts_torch.models.decoder import MambaTTSDecoder
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.parallel.dryrun import train_check
from mamba_tts_torch.parallel.mesh import gather_params, make_mesh, replicate, shard_batch
from mamba_tts_torch.parallel.sp_scan import sp_selective_scan
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.train.train import batch_to_device, init_params, make_train_step


def _np(t):
    return t.detach().float().numpy()


def scan_check(inputs, weights):
    """The time-sharded scan over every rank on the "data" axis: y, h_final
    and the gradients of sum(y * wy) + sum(h * wh)."""
    mesh = make_mesh((dist.get_world_size(),), ("data",), device_type="cpu")
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    y, h = sp_selective_scan(*ts, mesh)
    ((y * torch.from_numpy(weights[0])).sum() + (h * torch.from_numpy(weights[1])).sum()).backward()
    return {"y": _np(y), "h": _np(h), "grads": [_np(t.grad) for t in ts]}


def decoder_check(cfg_json, params, inputs):
    """A ``use_sp_scan`` decoder's loss and gradients (time-sharded over
    every rank)."""
    mesh = make_mesh((dist.get_world_size(),), ("data",), device_type="cpu")
    dec = load_params(MambaTTSDecoder(config_lib.from_json(cfg_json).decoder, sp_mesh=mesh),
                      params)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    logits = dec(t["audio_tokens"], t["text_hidden"], t["z_style"], t["text_mask"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -torch.gather(logp, -1, t["targets"].long()[..., None]).mean()
    loss.backward()
    return {"loss": float(loss.detach()),
            "grads": {n: _np(p.grad) for n, p in dec.named_parameters()}}


def sp_world(scan, decoder, step):
    """World of 2: the sp scan, the sp decoder, deterministic steps at the
    (2, 1) and (1, 2) meshes, and ``replicate`` (rank 0's tensors)."""
    mine = {"t": torch.full((3,), float(dist.get_rank() + 1))}
    replicate(mine, make_mesh((2,), ("data",), device_type="cpu"))
    return {"replicated": _np(mine["t"]), "scan": scan_check(*scan),
            "decoder": decoder_check(*decoder),
            "steps": {shape: train_check(*step, mesh_shape=shape)
                      for shape in ((2, 1), (1, 2))}}


def _loss(model, batch, style, mesh):
    tb = shard_batch({**batch, **style}, mesh)
    with torch.no_grad():
        return float(model.compute_losses(
            tb, deterministic=True, style_k=tb.pop("style_k"),
            style_eps=tb.pop("style_eps"))["loss_total"])


def _state(cfg, mesh, seed):
    model = MambaTTS(cfg, mesh=mesh)
    named = init_params(model, seed, mesh=mesh)
    tx = state_lib.make_optimizer(cfg.train.lr, cfg.train.grad_clip_norm, mesh=mesh,
                                  shardings=model.shardings)
    return model, tx, state_lib.create_train_state(named, tx)


def checkpoint_check(cfg_json, batch_np, style_np, ckdir):
    """Two train steps at (2, 2), saved; restored into a differently seeded
    init at (2, 2) and at (1, 4): this rank's params and moments, the step,
    and the next deterministic loss against the in-memory state's."""
    cfg = config_lib.from_json(cfg_json)
    batch = batch_to_device(batch_np, torch.device("cpu"))
    style = {"style_k": torch.from_numpy(style_np["k"]),
             "style_eps": torch.from_numpy(style_np["eps"])}
    mesh = make_mesh((2, 2), device_type="cpu")
    model, tx, st = _state(cfg, mesh, 0)
    step = make_train_step(model, tx, mesh=mesh)
    for _ in range(2):
        st, _ = step(st, shard_batch(batch, mesh))
    state_lib.save_checkpoint(ckdir, st, mesh=mesh, shardings=model.shardings)
    loss_mem = _loss(model, batch, style, mesh)
    full = gather_params(st.params, mesh, model.shardings)
    full_mu = gather_params(st.opt_state["mu"], mesh, model.shardings)

    model2, _, st2 = _state(cfg, mesh, 9)
    st2, ok = state_lib.restore_checkpoint(ckdir, st2, mesh=mesh)
    same_mesh = ok and st2.step == 2 and st2.opt_state["count"] == 2 and all(
        torch.equal(st.params[n], st2.params[n])
        and torch.equal(st.opt_state["mu"][n], st2.opt_state["mu"][n])
        and torch.equal(st.opt_state["nu"][n], st2.opt_state["nu"][n]) for n in st.params)

    mesh4 = make_mesh((1, 4), device_type="cpu")
    model4, _, st4 = _state(cfg, mesh4, 9)
    st4, ok4 = state_lib.restore_checkpoint(ckdir, st4, mesh=mesh4)
    full4 = gather_params(st4.params, mesh4, model4.shardings)
    full4_mu = gather_params(st4.opt_state["mu"], mesh4, model4.shardings)
    other_mesh = ok4 and st4.step == 2 and all(
        torch.equal(full[n], full4[n]) and torch.equal(full_mu[n], full4_mu[n]) for n in full)
    return {"same_mesh": same_mesh, "other_mesh": other_mesh, "loss_mem": loss_mem,
            "loss_restored": _loss(model2, batch, style, mesh),
            "loss_restored_1x4": _loss(model4, batch, style, mesh4)}


def dp_tp_world(step, noisy, clip, ckpt, odd):
    """World of 4: a deterministic step at (2, 2) and at (2, 2) with the
    scans time-sharded over "data" too, a step with dropout and noise (this
    rank's replicated parameters after it), a step whose global-norm clip
    triggers, the checkpoint round trip, and a deterministic step at (2, 2)
    of a model whose d_ff does not divide (its FFNs replicated)."""
    cfg_json, batch = step[0], step[1]
    sp_cfg = config_lib.from_json(cfg_json)
    sp_cfg = config_lib.override(sp_cfg, "decoder.use_sp_scan", True)
    return {"step": train_check(*step, mesh_shape=(2, 2)),
            "sp_step": train_check(config_lib.to_json(sp_cfg), batch, *step[2:],
                                   mesh_shape=(2, 2)),
            "noisy": train_check(*noisy, mesh_shape=(2, 2))["replicated"],
            "clip": train_check(*clip, mesh_shape=(2, 2)),
            "ckpt": checkpoint_check(*ckpt),
            "odd_step": train_check(*odd, mesh_shape=(2, 2))}


def _mixture_mean(model):
    def sample_style(style_bert, generator=None):
        pi, mu, _ = model.smsd(style_bert)
        return mu[torch.arange(mu.shape[0]), pi.argmax(-1)]
    return sample_style


@torch.no_grad()
def _tame(codec):
    """Halve every FACodec kernel: the random init drives almost every
    sample into tanh saturation, where the decode's batch size alone moves
    the waveform by ~1e-3 (``tame_codec_params`` of the other parity tests)."""
    for name, p in codec.named_parameters():
        if name.endswith("weight") and p.dim() > 1:
            p.mul_(0.5)


def serving_world(cfg_json, texts, styles, voices, frames):
    """World of 2: ``synthesize_batch`` on a "data" mesh against per-row
    ``synthesize`` (rank 0), the style draw pinned to the mixture mean and
    FACodec tamed; the megakernel's tokens on the mesh against one rank's."""
    from mamba_tts_torch.infer.synthesize import load_synthesizer

    cfg = config_lib.from_json(cfg_json)
    mesh = make_mesh((dist.get_world_size(),), ("data",), device_type="cpu")
    out = {}
    for quant in ("none", "megakernel"):
        synth_dp = load_synthesizer(cfg, quant=quant, mesh=mesh, device="cpu")
        synth = load_synthesizer(cfg, quant=quant, device="cpu")
        for s in (synth, synth_dp):
            s.model.sample_style = _mixture_mean(s.model)
            _tame(s.tokenizer.module)
        wav_dp, _ = synth_dp.synthesize_batch(texts, styles, voices, frames=frames)
        singles = ([synth.synthesize(t, s, v, frames=frames)[0]
                    for t, s, v in zip(texts, styles, voices)] if dist.get_rank() == 0 else None)
        out[quant] = {"wav_dp": np.asarray(wav_dp), "singles": singles}
    ids, _, mask = synth_dp.frontend.encode_batch(texts, pad_to=cfg.data.max_text_len)
    ids, mask, voice = synth_dp._tensors(ids, mask, synth_dp._encode_voice(voices))
    rows = (ids, mask, synth_dp.style_encoder.embed(styles), voice)
    out["megakernel"]["tokens_dp"] = synth_dp._decode_rows(rows, 4, 0.0, synth_dp._generator(0))
    out["megakernel"]["tokens_row0"] = synth._decode_rows(tuple(a[:1] for a in rows), 4, 0.0,
                                                          synth._generator(0))
    return out
