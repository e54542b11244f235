"""The port's multi-device receivers against the JAX package's, on four ranks each way.

The JAX side runs ``qampy_tpu.parallel`` in ``shard_map`` on a 4-device
mesh of the virtual CPU devices (``tests/conftest.py`` gives 8). The port
side runs four gloo ranks on CPU tensors: a module fixture starts them
once, as subprocesses of this file run as a script (whose ``__main__``
imports torch and the port, never JAX), hands them the inputs in an
``.npz``, computes the JAX references while they run, and reads back what
rank 0 gathered. Each test then compares one result. Inputs are numpy from
seeds, or JAX signals converted to numpy, at most 2^13 symbols a shard.

Tolerances, per case: the halo filter within 1e-5 of the output's rms (two
float32 filters summed in other orders); the cross-shard unwrap within
1e-5 rad (the local unwraps round alike, the offsets are exact multiples
of 2 pi); the data-parallel taps within 1e-5 (cma over a few blocks: rde
would expand rounding differences); the chains by shared decisions (>=
99.9 %, each mode at its best quarter turn) with both under the SER gate;
phases equal off near-ties of the search.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

SIZE = 4
OS = 2
FILT = dict(L=4 * 512, ntaps=17)                 # the halo filter's capture and taps
UNWRAP_L = 1024
NSYM_LOC = 2 ** 13                                # blind symbols a shard
TRAIN = dict(mu=1e-3, Niter=1, TrSyms_loc=512, rounds=2, block_size=128)
CHAIN = dict(os=OS, mu1=1.9e-3, mu2=1.9e-3, M=64, Ntaps=17, methods=("mcma", "mddma"),
             Niter=1, rounds=2, bps_angles=64, bps_N=14, block_size=256)
DEC = dict(N=12, dec=16, A=64)                   # the decimated stage (bench.py's decimated16)
ONE_TRS = 2 ** 14                                # the one-rank chain's training, as the bench's
GEN = dict(os=OS, mu1=1.9e-3, mu2=1.9e-3, M=64, Ntaps=17, methods=("mcma", "mcma"), Niter=2,
           rounds=3, bps_angles=32, bps_N=14, block_size=128)
PILOT = dict(M=16, frame_len=4096, seq_len=256, ins_rat=64)
PILOT_CHAIN = dict(os=OS, M=16, nmodes=2, Ntaps=17, Niter=10, cpe_avg=3)


# ---------------------------------------------------------------------------
# the ranks: torch and the port only
# ---------------------------------------------------------------------------

def _ranks_main(rank, size, addr, inp, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from qampy_tpu_torch.ops import equaliser as eqops
    from qampy_tpu_torch.ops._build import KernelLimit
    from qampy_tpu_torch.ops.chain import make_rx_chain
    from qampy_tpu_torch.ops.phase_cuda import bps_search
    from qampy_tpu_torch.parallel import init_distributed, make_mesh, sharded
    from qampy_tpu_torch.workload import warped_qam

    x = dict(np.load(inp))
    init_distributed(addr, size, rank, device="cpu")
    mesh = make_mesh(device="cpu")
    res = {}

    def planes(E):
        return eqops.planes(torch.as_tensor(E))

    def cplx(P):
        n = P.shape[0] // 2
        return torch.complex(P[:n], P[n:])

    def keep(name, t):
        res[name] = sharded.fetch_global(t, mesh)

    # the halo filter and the cross-shard unwrap
    w_f = torch.as_tensor(x["w_filt"])
    keep("filt", cplx(sharded._apply_filter_local(planes(sharded.shard_signal(x["E_filt"], mesh)),
                                                  OS, w_f, mesh)))
    un, offs = sharded._unwrap_across_shards(sharded.shard_signal(x["ph_wrapped"], mesh), mesh)
    keep("unwrap", un)
    res["unwrap_offsets"] = offs.numpy()
    ramp = sharded.shard_signal(np.arange(64, dtype=np.float32)[None], mesh)
    keep("halos", mesh.halos(ramp, 3))
    keep("halo_left", mesh.halo_from_left(ramp, 3))
    keep("halo_right", mesh.halo_from_right(ramp, 3))

    # data-parallel training: cma over a few blocks, taps equal on every rank
    P = planes(sharded.shard_signal(x["E_blind"], mesh))
    spec = eqops.err_spec("cma", eqops._reshape_symbols(None, "cma", 64, np.complex64, 2))
    w0 = torch.as_tensor(eqops._init_taps(CHAIN["Ntaps"], 2, 2, np.complex64))
    w = sharded._train_parallel(P, OS, TRAIN["mu"], w0, spec, TRAIN["Niter"],
                                TRAIN["TrSyms_loc"], True, TRAIN["rounds"],
                                TRAIN["block_size"], mesh)
    res["train_w"] = w.numpy()
    res["train_w_ranks"] = mesh.all_gather(w).numpy()

    # the single chain, and its launch check (no card needed to ask it)
    chain = sharded.make_sharded_rx_chain(mesh, bps_mode="single", **CHAIN)
    Eout, ph, evm = chain(sharded.shard_signal(x["E_blind"], mesh))
    keep("single", Eout)
    keep("single_ph", ph)
    res["single_evm"] = evm.numpy()
    bad = sharded.make_sharded_rx_chain(mesh, bps_mode="single", **dict(CHAIN, block_size=48))
    try:
        bad.check_launch()
        res["limit"] = np.array("")
    except KernelLimit as e:
        res["limit"] = np.array(str(e))

    # the decimated stage on given taps, with its filter and search laid bare
    dchain = sharded.make_sharded_rx_chain(mesh, bps_mode="decimated%d" % DEC["dec"],
                                           **dict(CHAIN, bps_N=DEC["N"], bps_angles=DEC["A"]))
    w_d = torch.as_tensor(x["w_dec"])
    (outr, outi), phu, _ = sharded._bps_local_decimated(P, w_d, mesh, dchain)
    keep("dec_out", torch.complex(outr, outi))
    keep("dec_phu", phu)
    eqp, decp = sharded._apply_filter_local(P, OS, w_d, mesh, DEC["dec"])
    keep("dec_eq", cplx(eqp))
    keep("dec_side", cplx(decp))
    De = mesh.halos(decp, DEC["N"])
    idx = bps_search(De[:2], De[2:], dchain.bps_cos, dchain.bps_sin, dchain.grid, DEC["N"])
    keep("dec_idx", idx[:, DEC["N"]:DEC["N"] + decp.shape[-1]].contiguous())

    # a general alphabet (the port alone, under the nearest-point gate)
    gchain = sharded.make_sharded_rx_chain(mesh, bps_mode="single", symbols=warped_qam(64), **GEN)
    keep("gen", gchain(sharded.shard_signal(x["E_gen"], mesh))[0])

    # the frame-parallel pilot receiver, replicated and sharded prefix
    E = sharded.replicate_signal(x["E_pil"], mesh)
    for sp in (False, True):
        rx = sharded.make_sharded_pilot_rx(mesh, x["pil_seq"], x["pil_ph"], PILOT["frame_len"],
                                           PILOT["ins_rat"], 1, shard_prefix=sp, **PILOT_CHAIN)
        data, shift, sc = rx(E)
        taps, _, mo, _ = rx.prefix(E)
        tag = "pil_sp" if sp else "pil"
        keep(tag, data)
        res[tag + "_shift"], res[tag + "_sc"] = shift.numpy(), sc.numpy()
        res[tag + "_mo"], res[tag + "_taps"] = mo.numpy(), taps.numpy()
        res[tag + "_state_ranks"] = mesh.all_gather(
            torch.cat([shift.to(torch.float32), mo.to(torch.float32), sc.reshape(1)])).numpy()
    rep = make_pilot_rx_chain_cpu(x, eq_trainer="ls")
    st = rep.prefix(rep._planes(E.real, E.imag))
    res["pil_rep_taps"], res["pil_rep_shift"] = st[0].numpy(), st[1].numpy()
    res["pil_rep_mo"], res["pil_rep_sc"] = st[2].numpy(), st[3].numpy()
    lms = make_pilot_rx_chain_cpu(x)             # the LMS trainer, one output mode a rank
    P_pil = lms._planes(E.real, E.imag)
    for tag, st in (("lms_sp", lms.prefix_sharded(P_pil, mesh)), ("lms_rep", lms.prefix(P_pil))):
        res[tag + "_taps"], res[tag + "_shift"], res[tag + "_mo"] = (t.numpy() for t in st[:3])

    # a world-size-1 group: the filter, the unwrap and the decimated chain on rank 0 alone
    g1 = dist.new_group([0])
    if rank == 0:
        m1 = make_mesh(g1, device="cpu")
        res["one_rank"] = np.array([m1.rank, m1.size])
        res["filt1"] = cplx(sharded._apply_filter_local(planes(x["E_filt"]), OS, w_f,
                                                        m1)).numpy()
        res["unwrap1"] = sharded._unwrap_across_shards(torch.as_tensor(x["ph_wrapped"]),
                                                       m1)[0].numpy()
        cfg = dict(CHAIN, bps_N=DEC["N"], rounds=1)
        c1 = sharded.make_sharded_rx_chain(m1, bps_mode="decimated16", TrSyms_loc=ONE_TRS, **cfg)
        Pw = planes(x["E_blind"])
        res["one_taps"] = c1.train_taps(Pw).numpy()
        res["one_out"] = c1(torch.as_tensor(x["E_blind"]))[0].numpy()
        rx_cfg = dict(M=64, Ntaps=17, os=OS, methods=CHAIN["methods"], mu=CHAIN["mu1"],
                      bps_angles=64, bps_N=DEC["N"], block_size=256, TrSyms=ONE_TRS,
                      bps_mode="decimated16")
        rxc = make_rx_chain(**rx_cfg, device="cpu")
        res["one_rx_out"] = rxc.forward(torch.as_tensor(x["E_blind"])).numpy()
        s1, s2 = rxc.specs      # RxChain.train_taps without the CMA guard between the stages
        _, w1, _ = eqops.train_block_planes(Pw, ONE_TRS, 1, OS, CHAIN["mu1"], rxc.w0, s1, True, 256)
        _, w2, _ = eqops.train_block_planes(Pw, ONE_TRS, 1, OS, CHAIN["mu1"], w1, s2, True, 256)
        res["one_rx_taps_unguarded"] = w2.numpy()

    # the helpers round trip
    xr = (np.arange(2 * 64) + 1j * np.arange(2 * 64)[::-1]).reshape(2, 64).astype(np.complex64)
    res["roundtrip"] = sharded.fetch_global(sharded.shard_signal(xr, mesh), mesh)
    res["replicated"] = sharded.replicate_signal(xr, mesh).numpy()
    res["stats_calls"] = np.array(mesh.stats["calls"])
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def make_pilot_rx_chain_cpu(x, **kw):
    from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
    return make_pilot_rx_chain(x["pil_seq"], x["pil_ph"], PILOT["frame_len"], PILOT["ins_rat"],
                               frames=(0,), device="cpu", **dict(PILOT_CHAIN, **kw))


if __name__ == "__main__":
    rank_, size_, addr_, inp_, out_ = sys.argv[1:6]
    sys.exit(_ranks_main(int(rank_), int(size_), addr_, inp_, out_))


# ---------------------------------------------------------------------------
# the test process: the JAX references beside the ranks' results
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

import qampy_tpu as qt  # noqa: E402
from qampy_tpu.ops import equaliser as jeq  # noqa: E402
from qampy_tpu.ops import phase as jph  # noqa: E402
from qampy_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from qampy_tpu.parallel import sharded as jsh  # noqa: E402
from qampy_tpu.parallel.mesh import TIME  # noqa: E402
from qampy_tpu_torch import workload  # noqa: E402
from qampy_tpu_torch.ops import equaliser as teq  # noqa: E402
from qampy_tpu_torch.ops.chain import make_rx_chain  # noqa: E402
from qampy_tpu_torch.ops.phase import bps_near_ties, detect_grid  # noqa: E402

RANKS_TIMEOUT = 300
FILT_TOL_REL = 1e-5
UNWRAP_TOL = 1e-5
TAPS_TOL = 1e-5
AGREE_MIN = 0.999
SER_MAX = 1e-4          # the blind chains at 2^15 x 2 symbols: both read 0 here
GEN_SER_MAX = 1e-2      # the reference's own gate for the sharded warped-64 chain (test_parallel.py:220)
PILOT_SER_MAX = 1e-2    # the reference's multi-process gate (tests/mp_worker.py:73)
PILOT_TAPS_TOL = 1e-3   # relative to the largest tap: one LS system per rank against a batch of
                        # two, whose right-hand sides the BLAS sums in other orders (1.6e-4 seen)
ROT_TOL = 1e-5          # two float32 rotations of one symbol by phases of a few rad


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _inputs():
    rng = np.random.default_rng(11)
    L = FILT["L"]
    E_filt = (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L))).astype(np.complex64)
    w_filt = (rng.standard_normal((2, 2, FILT["ntaps"]))
              + 1j * rng.standard_normal((2, 2, FILT["ntaps"]))).astype(np.complex64)
    t = np.arange(UNWRAP_L)
    ph_true = np.stack([np.cumsum(np.full(UNWRAP_L, 0.05)) + 0.3 * np.sin(t / 20),
                        -np.cumsum(np.full(UNWRAP_L, 0.07)) + 0.5 * np.cos(t / 13)])
    ph_wrapped = ((ph_true + np.pi) % (2 * np.pi) - np.pi).astype(np.float32)
    E_blind, syms, const = workload.make_tx(SIZE * NSYM_LOC, seed=2)
    # the decimated stage's taps: the port's single-card trainings on this capture
    rx = make_rx_chain(M=64, Ntaps=17, os=OS, methods=CHAIN["methods"], mu=CHAIN["mu1"],
                       block_size=256, TrSyms=2 ** 14, bps_mode="decimated16", device="cpu")
    w_dec = rx.train_taps(teq.planes(torch.as_tensor(E_blind))).numpy()
    # seed 1: on seed 4 the blind mcma stages lock onto no alphabet point in the reference's
    # sharded chain either (SER 0.4916 in both packages)
    E_gen, syms_gen, const_gen = workload.make_tx(SIZE * NSYM_LOC, const=workload.warped_qam(64),
                                                  seed=1)
    psig = qt.SignalWithPilots(PILOT["M"], PILOT["frame_len"], PILOT["seq_len"],
                               PILOT["ins_rat"], nframes=SIZE + 2, nmodes=2, fb=24e9, seed=3)
    ps2 = psig.resample(2 * psig.fb, beta=0.1, renormalise=True)
    ps2 = qt.impairments.simulate_transmission(ps2, snr=25, roll_frame_sync=True,
                                               key=jr.PRNGKey(4))
    return dict(E_filt=E_filt, w_filt=w_filt, ph_wrapped=ph_wrapped, E_blind=E_blind,
                syms=syms, const=const, w_dec=w_dec, E_gen=E_gen, syms_gen=syms_gen,
                const_gen=const_gen, E_pil=np.asarray(ps2.samples).astype(np.complex64),
                pil_seq=np.asarray(psig.pilot_seq).astype(np.complex64),
                pil_ph=np.asarray(psig.ph_pilots).astype(np.complex64),
                pil_coded=np.asarray(psig.coded_symbols).astype(np.complex64)), psig


def _dec_stage_f32(E_loc, wxy, angles_host, grid):
    """``qampy_tpu/parallel/sharded.py:_bps_local_decimated`` (:129-184) line for line, with
    its filter contracting in float32 (``mat_dtype``; the function's own call contracts in
    bf16, ~2^-8, which moves search indices off near-ties): the port's filter sums in
    float32 (ROADMAP queue C)."""
    from jax import lax
    from qampy_tpu.ops.equaliser_pallas import apply_filter_pallas_planes
    from qampy_tpu.ops.phase_pallas import bps_idx_pallas, interp_rotate_planes_pallas
    N, dec = DEC["N"], DEC["dec"]
    Ee = jsh._halo_from_right(E_loc, wxy.shape[-1] - 1 + OS)
    P = jnp.concatenate([Ee.real, Ee.imag], axis=0).astype(jnp.float32)
    Pout, Pdec = apply_filter_pallas_planes(P, OS, wxy, dec_stride=dec, mat_dtype=jnp.float32)
    no = Pout.shape[0] // 2
    Lout = E_loc.shape[-1] // OS
    Ld = Lout // dec
    eqp = (Pout[:no, :Lout], Pout[no:, :Lout])
    decp = (Pdec[:no, :Ld], Pdec[no:, :Ld])
    dr = jsh._halo_from_left(jsh._halo_from_right(decp[0], N), N)
    di = jsh._halo_from_left(jsh._halo_from_right(decp[1], N), N)
    idxd = bps_idx_pallas(None, angles_host, grid, N, T=2048, win_dtype=None, planes=(dr, di))
    A = angles_host.size
    phd = float(angles_host[0]) + float(np.pi / 2 / A) * idxd[:, N:-N].astype(jnp.float32)
    phu = jsh._unwrap_across_shards(phd * 4) / 4
    ndev = lax.axis_size(TIME)
    nxt = lax.ppermute(phu[:, :1], TIME, [(i, (i - 1) % ndev) for i in range(ndev)])
    b_blk = (jnp.concatenate([phu[:, 1:], nxt], axis=-1) - phu) / dec
    outr, outi = interp_rotate_planes_pallas(eqp[0], eqp[1], phu, b_blk, dx=dec, sign=1,
                                             T=2048)
    return outr + 1j * outi, phu


def _smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


def _jax_refs(x, psig):
    mesh = jax_mesh(SIZE)
    T = PS(None, TIME)
    r = {}
    w_f = jnp.asarray(x["w_filt"])
    r["filt"] = np.asarray(_smap(lambda e: jsh._apply_filter_local(e, OS, w_f), mesh, T, T)(
        x["E_filt"]))
    r["filt1"] = np.asarray(_smap(lambda e: jsh._apply_filter_local(e, OS, w_f), jax_mesh(1), T,
                                  T)(x["E_filt"]))
    r["unwrap"] = np.asarray(_smap(jsh._unwrap_across_shards, mesh, T, T)(x["ph_wrapped"]))
    ramp = np.arange(64, dtype=np.float32)[None]
    r["halos"] = np.asarray(_smap(lambda v: jsh._halo_from_left(jsh._halo_from_right(v, 3), 3),
                                  mesh, T, T)(ramp))

    syms_cma = jnp.asarray(jeq._reshape_symbols(None, "cma", 64, np.complex64, 2))
    w0 = jnp.asarray(jeq._init_taps(CHAIN["Ntaps"], 2, 2, np.complex64))
    r["train_w"] = np.asarray(_smap(
        lambda e: jsh._train_parallel(e, OS, TRAIN["mu"], w0, syms_cma, "cma", TRAIN["Niter"],
                                      TRAIN["TrSyms_loc"], True, TRAIN["rounds"],
                                      TRAIN["block_size"], pallas=False),
        mesh, T, PS())(x["E_blind"]))

    chain = jsh.make_sharded_rx_chain(mesh, pallas=False, bps_mode="single", **CHAIN)
    r["single"] = np.asarray(chain(x["E_blind"])[0])

    angles = np.linspace(-np.pi / 4, np.pi / 4, DEC["A"], endpoint=False, dtype=np.float32)
    const = x["const"]
    grid = jph.detect_grid(const)
    w_d = jnp.asarray(x["w_dec"])

    out, phu = _smap(lambda e: jsh._bps_local_decimated(e, OS, w_d, angles, grid, DEC["N"],
                                                        DEC["dec"], 2048, win_dtype=None),
                     mesh, T, (T, T))(x["E_blind"])
    r["dec_out"], r["dec_phu"] = np.asarray(out), np.asarray(phu)
    out, phu = _smap(lambda e: _dec_stage_f32(e, w_d, angles, grid), mesh, T, (T, T))(
        x["E_blind"])
    r["dec32_out"], r["dec32_phu"] = np.asarray(out), np.asarray(phu)

    kw = dict(PILOT_CHAIN)
    for sp in (False, True):
        rx = jsh.make_sharded_pilot_rx(mesh, x["pil_seq"], x["pil_ph"], PILOT["frame_len"],
                                       PILOT["ins_rat"], 1, shard_prefix=sp, **kw)
        data, shift, sc = rx(jsh.replicate_signal(x["E_pil"], mesh))
        tag = "pil_sp" if sp else "pil"
        r[tag], r[tag + "_shift"], r[tag + "_sc"] = map(np.asarray, (data, shift, sc))
    from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain as jax_pilot_chain
    fwd = jax_pilot_chain(x["pil_seq"], x["pil_ph"], PILOT["frame_len"], PILOT["ins_rat"],
                          frames=(0,), eq_trainer="ls", **kw)
    st = _smap(lambda e: fwd.prefix_sharded(e.real, e.imag, TIME, SIZE), mesh, PS(None, None),
               (PS(), PS(), PS(), PS(), PS()))(x["E_pil"])
    r["pil_sp_taps"], r["pil_sp_state_shift"], r["pil_sp_mo"] = map(np.asarray, st[:3])
    r["pil_data_tx"] = psig.get_data()
    return r


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, JAX references, the ranks' results)."""
    d = tmp_path_factory.mktemp("parallel")
    x, psig = _inputs()
    inp, out = str(d / "in.npz"), str(d / "out.npz")
    np.savez(inp, **x)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    addr = "localhost:%d" % _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(SIZE), addr,
                               inp, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(SIZE)]
    try:
        refs = _jax_refs(x, psig)
        logs = [p.communicate(timeout=RANKS_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, "rank %d failed (rc=%s):\n%s" % (r, p.returncode, log[-4000:])
    return x, refs, dict(np.load(out))


def test_halo_filter(ranks):
    """The whole output, the circular tail included, against the reference's shard_map."""
    x, refs, got = ranks
    want = refs["filt"]
    assert got["filt"].shape == want.shape == (2, FILT["L"] // OS)
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.max(np.abs(got["filt"] - want)) <= FILT_TOL_REL * rms


def test_cross_shard_unwrap(ranks):
    x, refs, got = ranks
    assert np.max(np.abs(got["unwrap"] - refs["unwrap"])) <= UNWRAP_TOL
    assert np.allclose(got["unwrap"], np.unwrap(x["ph_wrapped"].astype(np.float64)), atol=1e-3)
    offs = got["unwrap_offsets"]
    k = offs / np.float32(2 * np.pi)
    assert offs.shape == (SIZE, 2) and np.all(offs[0] == 0) and np.allclose(k, np.round(k))


def test_left_halo_is_the_left_neighbours_tail(ranks):
    """The port's halos, and the reference's fault: its composed exchange
    (sharded.py:101, 160-161) gives each shard its own first N samples as left halo."""
    _, refs, got = ranks
    n, loc = 3, 64 // SIZE
    for d in range(SIZE):
        mine = got["halos"][0, d * (loc + 2 * n):(d + 1) * (loc + 2 * n)]
        left = (np.arange(d * loc - n, d * loc) % 64).astype(np.float32)
        right = (np.arange((d + 1) * loc, (d + 1) * loc + n) % 64).astype(np.float32)
        assert np.array_equal(mine, np.concatenate([left, np.arange(d * loc, (d + 1) * loc),
                                                    right]))
        ref = refs["halos"][0, d * (loc + 2 * n):(d + 1) * (loc + 2 * n)]
        assert np.array_equal(ref[:n], np.arange(d * loc, d * loc + n))
        assert np.array_equal(ref[n:], mine[n:])
        # each exchange alone, as the reference's _halo_from_left and _halo_from_right
        assert np.array_equal(got["halo_left"][0, d * (loc + n):(d + 1) * (loc + n)], mine[:-n])
        assert np.array_equal(got["halo_right"][0, d * (loc + n):(d + 1) * (loc + n)], mine[n:])


def test_train_parallel(ranks):
    _, refs, got = ranks
    assert np.max(np.abs(got["train_w"] - refs["train_w"])) <= TAPS_TOL
    assert all(np.array_equal(w, got["train_w"]) for w in got["train_w_ranks"])


def test_single_chain(ranks):
    """The single chain beside the reference's with pallas=False (float32 windows):
    decisions shared and both under the SER gate; the global EVM a plain mean."""
    x, refs, got = ranks
    const, trim = x["const"], slice(workload.GATE_TRIM, -workload.GATE_TRIM)
    out, ref = torch.as_tensor(got["single"]), torch.from_numpy(np.array(refs["single"]))
    assert out.shape == (2, SIZE * NSYM_LOC)
    assert workload.shared_decisions(ref[:, trim], out[:, trim], const) >= AGREE_MIN
    syms = torch.as_tensor(x["syms"])
    for o in (out, ref):
        assert workload.ser_gate(o, syms, const) <= SER_MAX
    d = got["single"] - const[np.argmin(np.abs(got["single"][..., None] - const), -1)]
    assert np.isclose(float(got["single_evm"]), np.sqrt(np.mean(np.abs(d) ** 2)), rtol=1e-4)
    assert got["single_ph"].shape == out.shape


def _dec_zones():
    """Per decimated position: False where the reference's window reads its wrong left halo
    (the first N of each shard)."""
    ld = NSYM_LOC // DEC["dec"]
    keep = np.ones(SIZE * ld, bool)
    for d in range(SIZE):
        keep[d * ld:d * ld + DEC["N"]] = False
    return keep


def test_decimated_stage(ranks):
    """The decimated stage against the reference's on the same taps: equal off near-ties of
    the search, except where the two differ by design: the first N decimated positions of
    each shard, whose windows read the reference's wrong left halo
    (test_left_halo_is_the_left_neighbours_tail), and the last dec-1 symbols of the last
    shard (test_last_slope_is_zero). Held against ``_bps_local_decimated`` line for line with
    a float32 filter (``_dec_stage_f32``); the function itself, whose filter contracts in
    bf16, shares the decisions."""
    x, refs, got = ranks
    dec, N = DEC["dec"], DEC["N"]
    grid = detect_grid(x["const"])
    chain = make_rx_chain(M=64, bps_angles=DEC["A"], bps_N=N, bps_mode="decimated16",
                          device="cpu")
    # the near-ties of the side output with its circular halos, as the ranks searched it
    side = torch.as_tensor(got["dec_side"])
    full = torch.cat([side[:, -N:], side, side[:, :N]], -1)
    ties = bps_near_ties(full.real.contiguous(), full.imag.contiguous(), chain.bps_cos,
                         chain.bps_sin, grid, N)[:, N:-N].any(0).numpy()
    keep = _dec_zones() & ~ties
    assert keep.mean() > 0.95
    assert np.max(np.abs(got["dec_phu"] - refs["dec32_phu"])[:, keep]) <= UNWRAP_TOL
    # block j turns by phu[j] and the slope to phu[j+1]
    blk = keep & np.append(keep[1:], True)
    sym_keep = np.repeat(blk, dec)
    sym_keep[-dec + 1:] = False
    scale = np.max(np.abs(refs["dec32_out"]))
    assert np.max(np.abs(got["dec_out"] - refs["dec32_out"])[:, sym_keep]) <= ROT_TOL * scale
    trim = slice(workload.GATE_TRIM, -workload.GATE_TRIM)
    assert workload.shared_decisions(torch.from_numpy(np.array(refs["dec_out"][:, trim])),
                                     torch.as_tensor(got["dec_out"][:, trim]),
                                     x["const"]) >= AGREE_MIN


def test_decimated_search_matches_unsharded(ranks):
    """Every shard's search, halos on both sides, equals the search over the whole
    (circular) side output off near-ties: no position of a shard is special."""
    x, _, got = ranks
    N = DEC["N"]
    grid = detect_grid(x["const"])
    chain = make_rx_chain(M=64, bps_angles=DEC["A"], bps_N=N, bps_mode="decimated16",
                          device="cpu")
    side = torch.as_tensor(got["dec_side"])
    full = torch.cat([side[:, -N:], side, side[:, :N]], -1)
    er, ei = full.real.contiguous(), full.imag.contiguous()
    from qampy_tpu_torch.ops.phase_cuda import bps_search
    want = bps_search(er, ei, chain.bps_cos, chain.bps_sin, grid, N)[:, N:-N].numpy()
    ties = bps_near_ties(er, ei, chain.bps_cos, chain.bps_sin, grid, N)[:, N:-N].numpy()
    assert np.array_equal(got["dec_idx"][~ties], want[~ties])


def test_last_slope_is_zero(ranks):
    """The last rank's last block: the port derotates it by its own phase (slope 0, as the
    single-card chain); the reference by the slope toward the capture's first phase, wrapped
    around (sharded.py:177-180)."""
    x, refs, got = ranks
    dec = DEC["dec"]
    eq = got["dec_eq"][:, -dec:]
    phu_last = got["dec_phu"][:, -1:]
    k = np.arange(dec, dtype=np.float32)
    port = eq * np.exp(1j * phu_last)
    b_wrap = (refs["dec32_phu"][:, :1] - refs["dec32_phu"][:, -1:]) / dec
    ref = eq * np.exp(1j * (refs["dec32_phu"][:, -1:] + b_wrap * k))
    scale = np.max(np.abs(eq))
    assert np.max(np.abs(got["dec_out"][:, -dec:] - port)) <= ROT_TOL * scale
    assert np.max(np.abs(refs["dec32_out"][:, -dec:] - ref)) <= ROT_TOL * scale
    assert np.max(np.abs(b_wrap)) > 1e-3        # the wrapped slope is not 0 on this capture


def test_gen_alphabet_chain(ranks):
    """symbols=warped_qam(64): the port's sharded single chain under the nearest-point gate."""
    x, _, got = ranks
    ser = workload.ser_gate(torch.as_tensor(got["gen"]), torch.as_tensor(x["syms_gen"]),
                            x["const_gen"])
    assert ser <= GEN_SER_MAX


def test_kernel_limit_named(ranks):
    _, _, got = ranks
    assert "multiple of 32" in str(got["limit"])


def _pilot_ser(refs, data):
    return np.asarray(refs["pil_data_tx"].replace(samples=data).cal_ser(synced=True))


@pytest.mark.parametrize("sp", [False, True], ids=["replicated", "shard_prefix"])
def test_sharded_pilot_rx(ranks, sp):
    """Against the reference's make_sharded_pilot_rx (frames_per_device=1): shift, sync_corr,
    decisions; every rank acquired the same state."""
    x, refs, got = ranks
    tag = "pil_sp" if sp else "pil"
    assert np.array_equal(got[tag + "_shift"], refs[tag + "_shift"][:2])
    assert np.isclose(float(got[tag + "_sc"]), float(refs[tag + "_sc"][0]), rtol=1e-4)
    assert all(np.array_equal(s, got[tag + "_state_ranks"][0])
               for s in got[tag + "_state_ranks"])
    assert np.array_equal(got[tag + "_mo"], refs["pil_sp_mo"])
    a, b = got[tag], refs[tag]
    assert a.shape == b.shape
    assert workload.shared_decisions(torch.from_numpy(np.array(b)), torch.as_tensor(a),
                                     x["pil_coded"]) >= AGREE_MIN
    ser_p, ser_r = _pilot_ser(refs, a), _pilot_ser(refs, b)
    assert np.all(ser_p < PILOT_SER_MAX) and np.all(ser_r < PILOT_SER_MAX)


def test_shard_prefix_matches_replicated(ranks):
    """prefix_sharded against the port's replicated prefix and the reference's prefix_sharded:
    shift and mode order equal, taps within PILOT_TAPS_TOL of the largest tap."""
    _, refs, got = ranks
    assert np.array_equal(got["pil_sp_shift"], got["pil_rep_shift"])
    assert np.array_equal(got["pil_sp_mo"], got["pil_rep_mo"])
    assert np.isclose(float(got["pil_sp_sc"]), float(got["pil_rep_sc"]), rtol=1e-5)
    scale = np.max(np.abs(got["pil_rep_taps"]))
    assert np.max(np.abs(got["pil_sp_taps"] - got["pil_rep_taps"])) <= PILOT_TAPS_TOL * scale
    assert np.array_equal(got["pil_sp_shift"], refs["pil_sp_state_shift"])
    assert np.array_equal(got["pil_sp_mo"], refs["pil_sp_mo"])
    assert np.max(np.abs(got["pil_sp_taps"] - refs["pil_sp_taps"])) <= PILOT_TAPS_TOL * scale


def test_shard_prefix_lms(ranks):
    """prefix_sharded with the LMS trainer (each rank trains its output mode's row alone)
    against the replicated LMS prefix."""
    _, _, got = ranks
    assert np.array_equal(got["lms_sp_shift"], got["lms_rep_shift"])
    assert np.array_equal(got["lms_sp_mo"], got["lms_rep_mo"])
    scale = np.max(np.abs(got["lms_rep_taps"]))
    assert np.max(np.abs(got["lms_sp_taps"] - got["lms_rep_taps"])) <= PILOT_TAPS_TOL * scale


def test_world_size_one(ranks):
    """A group of one rank: the halo filter and unwrap wrap onto the shard itself, and the
    decimated chain trains the single-card chain's taps (no CMA guard fires here) and shares
    its decisions."""
    x, refs, got = ranks
    assert list(got["one_rank"]) == [0, 1]
    rms = np.sqrt(np.mean(np.abs(refs["filt1"]) ** 2))
    assert np.max(np.abs(got["filt1"] - refs["filt1"])) <= FILT_TOL_REL * rms
    assert np.allclose(got["unwrap1"], np.unwrap(x["ph_wrapped"].astype(np.float64)), atol=1e-3)
    assert np.array_equal(got["one_taps"], got["one_rx_taps_unguarded"])
    out, rx = torch.as_tensor(got["one_out"]), torch.as_tensor(got["one_rx_out"])
    trim = slice(workload.GATE_TRIM, rx.shape[-1] - workload.GATE_TRIM)
    assert workload.shared_decisions(rx[:, trim], out[:, trim], x["const"]) >= AGREE_MIN


def test_shard_replicate_fetch(ranks):
    _, _, got = ranks
    xr = (np.arange(2 * 64) + 1j * np.arange(2 * 64)[::-1]).reshape(2, 64).astype(np.complex64)
    assert np.array_equal(got["roundtrip"], xr)
    assert np.array_equal(got["replicated"], xr)
    assert int(got["stats_calls"]) > 0
