"""The port's parallel-config auto-tuner against the JAX package's
(``tests/test_auto_tuner.py``'s spaces).

Every field of ``TuneSpace`` is given explicitly to both packages (their
defaults differ: a TPU v5e's against an H100's), so the candidates,
the prune reasons, the memory and step-time estimates and the chosen
top three must be equal, the floats bit for bit (the same formulas in
the same order)."""

import dataclasses

import pytest

from paddle_tpu.distributed import auto_tuner as jat
from paddle_tpu_torch.distributed import auto_tuner as pat

PEAKS = dict(hbm_bytes=15.75e9, flops_peak=197e12, ici_bw=4.5e10,
             mfu_assumed=0.45, bytes_per_param=2,
             optimizer_bytes_per_param=12)

SPACES = {
    "gpt_1_3b_8": dict(n_devices=8, num_layers=24, hidden_size=2048,
                       num_heads=16, vocab_size=50304, seq_len=1024,
                       global_batch=64),
    "gpt_1_3b_1_tiny_hbm": dict(n_devices=1, num_layers=24,
                                hidden_size=2048, num_heads=16,
                                vocab_size=50304, seq_len=1024,
                                global_batch=64, hbm_bytes=1e9),
    "gpt_125m_8": dict(n_devices=8, num_layers=12, hidden_size=768,
                       num_heads=12, vocab_size=50304, seq_len=1024,
                       global_batch=64),
    "gpt_125m_8_h100": dict(n_devices=8, num_layers=12, hidden_size=768,
                            num_heads=12, vocab_size=50304, seq_len=1024,
                            global_batch=64, hbm_bytes=80e9,
                            flops_peak=989e12, ici_bw=4.5e11),
}


def _both(name):
    kw = {**PEAKS, **SPACES[name]}
    return jat.TuneSpace(**kw), pat.TuneSpace(**kw)


def _c(c):
    return (c.dp, c.mp, c.pp, c.sharding, c.micro_batches)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_search_matches_jax(name):
    js, ps = _both(name)
    jt, pt = jat.AutoTuner(js), pat.AutoTuner(ps)
    assert ps.n_params == js.n_params
    jc, pc = list(jt.candidates()), list(pt.candidates())
    assert [_c(c) for c in pc] == [_c(c) for c in jc]
    for a, b in zip(jc, pc):
        assert pt.prune_reason(b) == jt.prune_reason(a), _c(a)
        assert pt.est_hbm(b) == jt.est_hbm(a), _c(a)
        assert pt.est_step_time(b) == jt.est_step_time(a), _c(a)
    try:
        jbest = jat.AutoTuner(js).tune()
    except ValueError as e:
        with pytest.raises(ValueError, match="every candidate pruned"):
            pat.AutoTuner(ps).tune()
        assert "every candidate pruned" in str(e)
        return
    jtune, ptune = jat.AutoTuner(js), pat.AutoTuner(ps)
    jtune.tune()
    pbest = ptune.tune()
    assert _c(pbest) == _c(jbest)
    assert (pbest.est_step_time, pbest.est_hbm) == (jbest.est_step_time,
                                                    jbest.est_hbm)
    jr = [_c(c) for c, why in jtune.history if why == "ranked"][:3]
    pr = [_c(c) for c, why in ptune.history if why == "ranked"][:3]
    assert pr == jr
    assert [(_c(c), w) for c, w in ptune.history] == \
        [(_c(c), w) for c, w in jtune.history]


def test_trial_fn_and_failures_match_jax():
    js, ps = _both("gpt_1_3b_8")
    picks = {}
    for pkg, space in (("jax", js), ("port", ps)):
        calls = []

        def trial(c):
            calls.append(_c(c))
            return 1.0 / len(calls)
        tuner = (jat if pkg == "jax" else pat).AutoTuner(space)
        best = tuner.tune(trial_fn=trial, top_n=3)
        failed = (jat if pkg == "jax" else pat).AutoTuner(space).tune(
            trial_fn=lambda c: (_ for _ in ()).throw(RuntimeError("oom")),
            top_n=2)
        picks[pkg] = (calls, _c(best), best.measured, _c(failed))
    assert picks["port"] == picks["jax"]
    assert pat.tune(**{**PEAKS, **SPACES["gpt_1_3b_8"]}).degrees == \
        jat.tune(**{**PEAKS, **SPACES["gpt_1_3b_8"]}).degrees


def test_defaults_are_the_cards():
    """The port's defaults are an H100 SXM's (the card's own memory
    where one is present), not the v5e's of the JAX package."""
    import torch
    ps = pat.TuneSpace(**SPACES["gpt_125m_8"])
    js = jat.TuneSpace(**SPACES["gpt_125m_8"])
    assert ps.flops_peak == 989e12 and js.flops_peak == 197e12
    assert ps.ici_bw == 4.5e11 and js.ici_bw == 4.5e10
    want = (torch.cuda.get_device_properties(0).total_memory
            if torch.cuda.is_available() else 80e9)
    assert ps.hbm_bytes == want and js.hbm_bytes == 15.75e9
    fields = {f.name for f in dataclasses.fields(pat.TuneSpace)}
    assert fields == {f.name for f in dataclasses.fields(jat.TuneSpace)}
    # a space the v5e's memory prunes fits the card's: 1.3B on 8 cards
    # keeps the pure data-parallel layout
    big = dict(SPACES["gpt_1_3b_8"])
    pbest = pat.AutoTuner(pat.TuneSpace(**big)).tune()
    assert pbest.est_hbm <= want
    reason = jat.AutoTuner(jat.TuneSpace(**big)).prune_reason(
        jat.Candidate(8, 1, 1, 1, 8))
    assert reason is not None and "HBM" in reason
    assert pat.AutoTuner(pat.TuneSpace(**big)).prune_reason(
        pat.Candidate(8, 1, 1, 1, 8)) is None
