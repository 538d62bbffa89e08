"""The comparison that decides ``correct``, shown to fail: each run here
skips the look for a card and drives the rest of a run on the CPU at the
smoke size, sound once and then with the timed path broken underneath.
The control's readings (a lower precision in the system's place) must read
above the sound program's on the same seed; on the card, at the cells'
own sizes, ``portbench/control.py`` reads them."""
from __future__ import annotations

import pytest
import torch

from portbench import control, generator, run
from portbench.drivers import serve, train
from portbench.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("tiny")
    return root, tiny.make(root)


def _run(bench, cell, fault=None, seed=21):
    root, spec = bench
    return run.execute(cell, seed, 0.05, False, "cpu", spec=spec, fault=fault, root=root)


@pytest.mark.parametrize("cell", ["tiny.one", "tiny-mk.one", "tiny.batch", "tiny.train"])
def test_sound_runs_are_correct(bench, cell):
    r = _run(bench, cell)
    assert r["correct"] and r["failed"] == 0, r["checks"]


def _unchanged(model, tx, step):
    def apply(params, grads, opt_state, norm=None):
        return {**opt_state, "count": opt_state["count"] + 1}

    tx.apply = apply
    return step


def _altered(synth):
    decode = synth.decode_tokens

    def one_token_off(*a, **k):
        tok = decode(*a, **k).clone()
        V = synth.cfg.decoder.codebook_size
        tok[:, 7] = (tok[:, 7] - 2 + V // 2) % V + 2
        return tok

    synth.decode_tokens = one_token_off


def _half_rows(synth):
    decode = synth.decode_tokens

    def half(ids, mask, style, voice, frames, *a, **k):
        h = ids.shape[0] // 2
        tok = decode(ids[:h], mask[:h], style[:h], voice[:h], frames, *a, **k)
        return torch.cat([tok, tok[-1:].expand(ids.shape[0] - h, -1)])

    synth.decode_tokens = half


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train", _unchanged),
    ("tiny.train", train.half_batch),
    ("tiny.one", _altered),
    ("tiny-mk.one", _altered),
    ("tiny.batch", _half_rows),
])
def test_a_broken_timed_path_is_not_correct(bench, cell, fault):
    assert not _run(bench, cell, fault)["correct"]


@pytest.mark.parametrize("cell", ["tiny.one", "tiny.train"])
def test_the_control_reads_above_the_program(bench, cell):
    root, spec = bench
    w = run.cell_entry(spec, cell)
    conf = generator.load_json("configs", w["config"], root)
    traffic = generator.load_json("traffic", w["traffic"], root)
    limits = generator.load_json("limits", cell, root)
    driver = run.load_driver(traffic["kind"])
    rows = {r["reading"]: r for r in driver.readings(conf, traffic, limits, 5, 0.05, "cpu")}
    assert rows["program"]["correct"]
    if traffic["kind"] == "serve":
        for k in ("logit_gap", "logit_gap_mean", "argmax_miss"):
            assert rows["control_fp8"][k] > rows["program"][k]
            assert k in rows["control_int8_weights"]
    else:
        for k in ("grad_gap", "change_median_gap", "change_p90_gap", "change_component_gap"):
            assert rows["control_fp8"][k] > rows["program"][k]
            assert rows["fault_half_batch"][k] > rows["program"][k]


@pytest.mark.parametrize("dtypes", [("int8", "int8"), ("bfloat16", "int8")])
def test_a_decode_in_another_precision_than_stated_is_not_correct(bench, dtypes, monkeypatch):
    """The megakernel cell states bf16 weights and K/V: a planner that picks
    int8 for either serves tokens that may still read close, and the run
    is not correct all the same."""
    from mamba_tts_torch.infer import synthesize

    monkeypatch.setattr(synthesize, "_megakernel_dtypes", lambda *a, **k: dtypes)
    r = _run(bench, "tiny-mk.one")
    assert not r["correct"]
    assert r["checks"]["decode_path"]["value"] == [["megakernel", *dtypes]]


def test_the_decode_path_is_restored_after_the_run(bench):
    from mamba_tts_torch.infer import synthesize

    before = synthesize.megakernel_greedy_decode
    r = _run(bench, "tiny-mk.one")
    assert r["checks"]["decode_path"]["value"] == [["megakernel", "bfloat16", "bfloat16"]]
    assert synthesize.megakernel_greedy_decode is before


@pytest.mark.parametrize("faulty,caught", [
    (("b.0", "b.1", "b.2", "b.3"), ("change_p90_gap", "change_component_gap")),
    (("b.0", "b.1"), ("change_component_gap",)),
])
def test_a_fault_in_a_few_leaves_fails_the_p90_or_the_component_leaf(faulty, caught):
    """Leaves that move twice as far as the reference's leave the median
    leaf's change alone: a fifth of them fail the 90th-percentile leaf,
    and two of a component's three its median leaf."""
    names = [f"a.{i}" for i in range(20 - (4 if len(faulty) == 4 else 3))]
    names += [f"b.{i}" for i in range(4 if len(faulty) == 4 else 3)]
    ref = ([{"loss_total": 1.0}], {n: 1.0 for n in names}, {n: 1.0 for n in names})
    change = {n: (2.0 if n in faulty else 1.0) for n in names}
    limits = {**tiny.LIMITS["train"], "change_component_gap": 5e-2}
    c = train.compare(limits, [{"loss_total": 1.0}], dict(ref[1]), change, ref)
    assert c["change_median_gap"]["value"] == 0.0 and not c["pass"]
    for k in ("change_p90_gap", "change_component_gap"):
        assert (c[k]["value"] == 1.0) == (k in caught)


def test_gaps_count_every_position():
    g = serve.Gaps()
    g.add(torch.tensor([0.0, 0.5, 0.0, 0.0]))
    g.add(torch.tensor([0.25, 0.0]))
    assert g.numbers() == {"logit_gap": 0.5, "logit_gap_mean": 0.125,
                           "argmax_miss": 100.0 * 2 / 6}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mk.interactive", "bf16.train-flagship"])
def test_control_fails_the_limits_on_the_card(cell, tmp_path):
    """At the cell's own size on the card: the control (and for training the
    half-batch fault) fails one of the cell's numbers on a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the control runs at the cell's own size")
    out = tmp_path / "c.jsonl"
    control.main(["--workload", cell, "--seeds", "2147483999", "--seconds", "3",
                  "--out", str(out)])
    import json

    rows = [json.loads(x) for x in out.read_text().splitlines()]
    limits = generator.load_json("limits", cell)
    prog = next(r for r in rows if r["reading"] == "program")
    assert all(prog[k] <= v for k, v in limits.items())
    conf = generator.load_json("configs", run.cell_entry(run.benchmark(), cell)["config"])
    for r in rows:
        # the megakernel's int8 path reads level with its bf16 one, whose
        # arithmetic sets the gaps; there the decode-path check holds it
        if r["reading"] == "program" or (r["reading"] == "control_int8_weights"
                                         and conf["decode"]["path"] == "megakernel"):
            continue
        assert any(r.get(k, 0.0) > v for k, v in limits.items()), r
