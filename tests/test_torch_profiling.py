"""The port's benchmark harness (``qampy_tpu_torch.profiling``) beside the JAX package's.

The two tests of tests/test_profiling.py on the port at 2^12 symbols, on the
CPU, where every group is plain PyTorch; the trace; and each group's
function fed the inputs of the reference's groups (numpy, seed 0) against
the JAX function the reference times: the decisions equal, the BPS indices
equal off near-ties of the window sums (the port rotates by a cos/sin table,
the reference by exp(1j a)), the cma taps within 1e-5 after the group's 15
blocks of 64, the filter within 1e-6 of its rms, the LLRs within 1e-4
relative, the angles exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qampy_tpu import profiling as jprof
from qampy_tpu.core import metrics as jmetrics
from qampy_tpu.ops import equaliser as jeq
from qampy_tpu.ops import phase as jphase
from qampy_tpu_torch import profiling
from qampy_tpu_torch.ops import phase as phops

NSYMS = 2 ** 12
GROUPS = {"decision", "bps", "train_cma", "apply_filter", "soft_llr", "select_angles"}


class TestHarness:
    def test_run_benchmarks_small(self):
        res = profiling.run_benchmarks(nsyms=NSYMS, reps=1, methods=("cma",), device="cpu")
        assert GROUPS <= set(res)
        assert all(v > 0 for v in res.values())

    def test_time_fn(self):
        t = profiling.time_fn(lambda x: x * 2, torch.ones(16), reps=2)
        assert t > 0


def test_routes_are_plain_on_the_cpu():
    res, routes = profiling.run_benchmarks(nsyms=NSYMS, reps=1, methods=("cma", "rde"),
                                           device="cpu", routes=True)
    assert set(res) == set(routes) == GROUPS | {"train_rde"}
    assert set(routes.values()) == {"plain"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        torch.ones(64).cumsum(0)
    fn = os.path.join(logdir, "trace.json")
    with open(fn) as f:
        assert "traceEvents" in json.load(f)


@pytest.fixture(scope="module")
def groups():
    return profiling.benchmark_groups(nsyms=NSYMS, methods=("cma",), device="cpu")


@pytest.fixture(scope="module")
def inputs():
    return profiling.group_inputs(NSYMS)


def test_inputs_are_the_references(inputs):
    const, z, angles, E2, idx = inputs
    rng = np.random.default_rng(0)
    zr = (rng.standard_normal(NSYMS) + 1j * rng.standard_normal(NSYMS)).astype(np.complex64)
    assert np.array_equal(z, zr * np.complex64(0.7)) and E2.shape == (2, NSYMS // 2)
    assert np.array_equal(profiling._bitmap(64).numpy(), np.asarray(jprof._bitmap(64)))


def test_decision(groups, inputs):
    const, z = inputs[:2]
    g = groups["decision"]
    assert np.array_equal(g.fn(*g.args).numpy(), np.asarray(jmetrics.decision_idx(z, const)))


def test_bps(groups, inputs):
    const, z, angles = inputs[:3]
    g = groups["bps"]
    got = g.fn(*g.args)[0].numpy()
    want = np.asarray(jphase.bps_idx(z, angles, const, profiling.BPS_N,
                                     grid=jphase.detect_grid(const)))
    er, ei, cos_t, sin_t, grid, N, _ = g.args
    ties = phops.bps_near_ties(er, ei, cos_t, sin_t, grid, N)[0].numpy()
    assert got.shape == want.shape and ties.mean() < 1e-2
    assert np.array_equal(got[~ties], want[~ties])


def test_train_cma(groups, inputs):
    const, z, angles, E2 = inputs[:4]
    g = groups["train_cma"]
    _, w, _ = g.fn(*g.args)
    trs = (E2.shape[-1] - profiling.TRAIN_TAPS) // 2
    w0 = jnp.asarray(jeq._init_taps(profiling.TRAIN_TAPS, 2, 2, np.complex64))
    syms = jnp.asarray(jeq._reshape_symbols(None, "cma", 64, np.complex64, 2))
    _, wj, _ = jeq.train_equaliser_block(E2, trs, 1, 2, 1e-3, w0, syms, "cma", adaptive=True,
                                         block_size=profiling.TRAIN_BLOCK)
    assert trs // profiling.TRAIN_BLOCK == 15
    assert np.abs(w.numpy() - np.asarray(wj)).max() <= 1e-5


def test_apply_filter(groups, inputs):
    E2 = inputs[3]
    g = groups["apply_filter"]
    out = g.fn(*g.args)
    got = torch.complex(out[:2], out[2:]).numpy()
    want = np.asarray(jeq.apply_filter_to_signal(E2, 2, jnp.asarray(g.args[2].numpy())))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.sqrt(np.mean(np.abs(want) ** 2))


def test_soft_llr(groups, inputs):
    z = inputs[1]
    g = groups["soft_llr"]
    got = g.fn(*g.args).numpy()
    want = np.asarray(jax.jit(lambda e: jmetrics.soft_l_value_demapper(
        e, profiling.LLR_SNR, jprof._bitmap(64)))(z))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_select_angles(groups, inputs):
    angles, idx = inputs[2], inputs[4]
    g = groups["select_angles"]
    want = np.asarray(jphase.select_angles(np.tile(angles, (NSYMS, 1)), idx))
    assert np.array_equal(g.fn(*g.args).numpy(), want)
