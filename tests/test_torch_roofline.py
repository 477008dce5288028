"""The port's roofline arithmetic (``repro_torch.launch.roofline``) against
the arithmetic half of the reference's ``repro/launch/roofline.py``: with
the port's constants set to the reference's, each of the seven functions
gives the reference's numbers on a grid of inputs (1e-12 relative), and
their ValueError guards fire on the same inputs. The port's own constants
are the H100's, and none of them is a TPU figure."""
from __future__ import annotations

import itertools
import math

import pytest
import torch

import repro.launch.roofline as jrf
import repro_torch.launch.roofline as rf
from repro.configs import ARCHS as JARCHS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro_torch.configs import ARCHS, INPUT_SHAPES

RTOL = 1e-12
MODES = ("none", "staleness1", "doublebuf", "staleness_k")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def same_constants(monkeypatch):
    """The port's module with the reference's hardware constants."""
    monkeypatch.setattr(rf, "PEAK_FLOPS", jrf.PEAK_FLOPS)
    monkeypatch.setattr(rf, "HBM_BW", jrf.HBM_BW)
    monkeypatch.setattr(rf, "LINK_BW", jrf.ICI_BW)
    monkeypatch.setattr(rf, "DISK_BW", jrf.DISK_BW)
    return rf


def _same(got, want, path="out"):
    """Equal structure; numbers within RTOL, everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, bool) or isinstance(want, str):
        assert got == want, (path, got, want)
    elif isinstance(want, (int, float)):
        if math.isinf(want):
            assert got == want, (path, got, want)
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=0.0), \
                (path, got, want)
    else:
        assert got == want, (path, got, want)


def _raises_alike(fn_port, fn_ref, **kw):
    """Both raise ValueError on ``kw``, or both return equal numbers."""
    try:
        want = fn_ref(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            fn_port(**kw)
        return False
    _same(fn_port(**kw), want)
    return True


def test_roofline_matches_reference(same_constants):
    colls = ({}, {"all-gather": {"bytes": 3.5e9}},
             {"all-reduce": {"bytes": 1e6}, "all-gather": {"bytes": 2e10}})
    for flops, nbytes, coll, scale in itertools.product(
            (0.0, 1e9, 3.7e15), (0.0, 2e6, 8.1e11), colls,
            (1.0, 0.25, 1 / 3)):
        _same(rf.roofline(flops, nbytes, coll, seconds_scale=scale),
              jrf.roofline(flops, nbytes, coll, seconds_scale=scale))


def test_overlap_model_matches_reference(same_constants):
    axes = ({}, {"data": 4.8e9}, {"data": 1e7, "model": 2e8},
            {"mixed": 3e9, "unknown": 1e5, "model": 1e6})
    for comp, mem, ax, R, scale in itertools.product(
            (0.0, 1e-4, 0.35), (0.0, 2e-3), axes, (1, 2, 4, 8, 16),
            (1.0, 0.125)):
        terms = {"compute_s": comp, "memory_s": mem}
        _same(rf.overlap_model(terms, ax, R=R, seconds_scale=scale),
              jrf.overlap_model(terms, ax, R=R, seconds_scale=scale))


def test_probe_round_model_matches_reference(same_constants):
    ran = 0
    for work, tau, gb, R, mode, k in itertools.product(
            (0.0, 1e-5, 0.02, 1.7), (0, 1, 4, 8), (0.0, 4.9e9, 1.95e10),
            (2, 4, 8), MODES + ("exact",), (0, 1, 2, 3, 4)):
        ran += _raises_alike(rf.probe_round_model, jrf.probe_round_model,
                             work_s_per_step=work, tau=tau, gather_bytes=gb,
                             R=R, mode=mode, staleness=k)
    assert ran > 0


def test_reconcile_probes_matches_reference(same_constants):
    cases = ([], [(0.0, 1.0)], [(5.0, 0.0)], [(10.0, 2.0)],
             [(10.0, 2.0), (30.0, 3.0)],
             [(2e6, 6.0e4), (3.3e6, 1.2e5), (5.8e6, 2.4e5)],
             [(1.0, 2.0), (4.0, 2.0), (9.0, 3.0), (1e3, 1.0), (7.0, 7.0)])
    for pairs in cases:
        _same(rf.reconcile_probes(iter(pairs)),
              jrf.reconcile_probes(iter(pairs)))


def test_model_flops_matches_reference(same_constants):
    for name in sorted(ARCHS):
        for sname in sorted(INPUT_SHAPES):
            for mode in ("train", "ddp", "prefill", "decode"):
                _same(rf.model_flops(ARCHS[name], INPUT_SHAPES[sname],
                                     mode=mode),
                      jrf.model_flops(JARCHS[name], JSHAPES[sname],
                                      mode=mode))


def test_serving_model_matches_reference(same_constants):
    ran = 0
    for name, slots, chunk, state, db in itertools.product(
            ("gemma2-2b", "zamba2-7b", "xlstm-350m", "dbrx-132b"),
            (0, 1, 4, 64), (0, 1, 512), (0.0, 3.2e5, 4.1e8), (2, 4)):
        ran += _raises_alike(
            lambda **kw: rf.serving_model(ARCHS[name], **kw),
            lambda **kw: jrf.serving_model(JARCHS[name], **kw),
            max_slots=slots, chunk=chunk, state_bytes_per_slot=state,
            dtype_bytes=db)
    assert ran > 0


def test_supervisor_model_matches_reference(same_constants):
    ran = 0
    for rounds, deg, retr, rest, rbytes, back in itertools.product(
            (0, 1, 8), (-1, 0, 2, 9), (-1, 0, 1), (-1, 0, 2),
            (-1.0, 0.0, 3.347e10), (-0.5, 0.0, 2.5)):
        ran += _raises_alike(
            rf.supervisor_model, jrf.supervisor_model, rounds=rounds,
            tau=4, work_s_per_step=0.05, gather_bytes=1.95e10, R=4,
            staleness=2, degraded_rounds=deg, retried_rounds=retr,
            restores=rest, restore_bytes=rbytes, backoff_s=back)
    assert ran > 0


def test_h100_constants_and_no_tpu_figure():
    """The port's constants are the H100's: bf16 dense 989 TFLOP/s, HBM
    3.35 TB/s, NVLink 4 450 GB/s each way (data sheet), the measured
    resume-point read ~1.04 GB/s; none is a TPU v5e figure or the
    reference's disk rate."""
    assert rf.PEAK_FLOPS == 989e12
    assert rf.HBM_BW == 3.35e12
    assert rf.LINK_BW == 450e9
    # 33.47 GB read back in 23.8-32.2 s (warm): the slowest read
    assert rf.DISK_BW == 33.47e9 / 32.2
    tpu = {jrf.PEAK_FLOPS, jrf.HBM_BW, jrf.ICI_BW, jrf.DISK_BW}
    assert not tpu & {rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW, rf.DISK_BW}
    assert not hasattr(rf, "ICI_BW")
    # each constant's source is named in the module's docstring
    doc = rf.__doc__
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "DISK_BW"):
        assert f"``{name}``" in doc
    assert "H100 80GB HBM3" in doc and "700 W" in doc


def test_h100_model_of_a_probe():
    """The probe model on the H100's constants: a round of four steps of
    yi-6b (4 layers, n = 1,216,385,024) on 2048-token sequences, batch 4,
    against its (4, n) fp32 gather over NVLink."""
    n, seq, M = 1_216_385_024, 2048, 4
    work = 6.0 * n * 4 * seq / rf.PEAK_FLOPS
    gather = M * n * 4 + M * M * 4
    got = rf.probe_round_model(work_s_per_step=work, tau=4,
                               gather_bytes=gather, R=M, mode="doublebuf")
    assert got == pytest.approx(4 * work + max(gather / rf.LINK_BW
                                               - 4 * work, 0.0), rel=RTOL)
    assert got == pytest.approx(0.2418109472, rel=1e-9)
