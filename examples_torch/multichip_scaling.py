"""The time-sharded blind receiver and the frame-parallel pilot receiver over ranks, on the port.

The port of ``examples/multichip_scaling.py``. ``main`` starts ``ranks``
processes of this script, one ``torch.distributed`` rank each on the gloo
backend (on one card they share it; on the CPU they are CPU processes),
and prints what rank 0 gathered:

* the dual-pol 64-QAM capture sharded over the ranks' time axis, the
  equaliser trained data-parallel with averaged taps (kernel B1 a rank),
  the halo'd filter (B2) and the phase search (B3, with B6 derotating);
* the same with the phase search on the filter's stride-8 side output and
  the derotation by interpolation (B4);
* the frame-parallel pilot receiver with its prefix spread over the ranks
  and the closed-form LS pilot trainer.

Ranks that share one card give no scaling figure, and none is printed.
Run: python examples_torch/multichip_scaling.py [--device cpu] [--ranks 4]
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

import _common
import numpy as np

# the decimated chain's data-parallel trainings read SER up to ~9e-4 on 2^14-2^15 symbols a
# rank in both packages (PERF.md, the sharded sweep): its gate is twice the reference's 1e-3
GATES = {"ser": ("<=", 1e-3), "decimated_ser": ("<=", 2e-3), "pilot_ser": ("<=", 1e-3)}


def rank_main(rank, size, addr, out, device, N, frame_len):
    import torch
    import qampy_tpu_torch as qt
    from qampy_tpu_torch import impairments
    from qampy_tpu_torch.parallel import init_distributed, make_mesh, sharded
    from qampy_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(addr, size, rank, backend="gloo", device=dev)
    mesh = make_mesh(device=dev)
    res = {"ranks": mesh.size}
    if rank == 0:
        print("mesh: %d gloo ranks on %s" % (mesh.size, dev))
    fb = 25e9
    sig = qt.SignalQAMGrayCoded(64, N, nmodes=2, fb=fb, seed=1, device=dev)
    s = impairments.apply_phase_noise(sig.resample(2 * fb, beta=0.1), 20e3,
                                      generator=_common.gen(5, dev))
    s = impairments.change_snr(s, 35, generator=_common.gen(3, dev))
    s = impairments.apply_PMD(s, np.pi / 5.6, 50e-12)
    E = sharded.shard_signal(s.samples, mesh)
    chain = sharded.make_sharded_rx_chain(mesh, os=2, mu1=1e-3, mu2=1e-3, M=64, Ntaps=17,
                                          methods=("cma", "rde"), rounds=2, bps_angles=64,
                                          bps_N=14)
    Eout, ph, evm = chain(E)
    rec = sig.replace(samples=torch.as_tensor(sharded.fetch_global(Eout, mesh), device=dev))
    res["evm"], res["ser"] = float(evm), rec.cal_ser().tolist()
    # the phase search on the filter's stride-8 side output, the derotation interpolated
    chain_dec = sharded.make_sharded_rx_chain(
        mesh, os=2, mu1=1.9e-3, mu2=1.9e-3, M=64, Ntaps=17, methods=("mcma", "mddma"), rounds=2,
        bps_angles=64, bps_N=14, block_size=128, bps_mode="decimated")
    Eout_d, _, _ = chain_dec(E)
    res["decimated_ser"] = sig.replace(samples=torch.as_tensor(
        sharded.fetch_global(Eout_d, mesh), device=dev)).cal_ser().tolist()
    # the frame-parallel pilot receiver, its prefix spread over the ranks, the LS trainer
    psig = qt.SignalWithPilots(64, frame_len, 512, 32, nframes=mesh.size + 2, nmodes=2,
                               fb=24e9, seed=7, device=dev)
    p2 = psig.resample(2 * psig.fb, beta=0.1, renormalise=True)
    p2 = impairments.simulate_transmission(p2, snr=30, lwdth=20e3, roll_frame_sync=True,
                                           generator=_common.gen(11, dev))
    pchain = sharded.make_sharded_pilot_rx(
        mesh, psig.pilot_seq.cpu().numpy(), psig.ph_pilots.cpu().numpy(), psig.frame_len,
        psig.pilot_ins_rat, frames_per_device=1, shard_prefix=True, os=2, M=64, nmodes=2,
        Ntaps=17, Niter=30, cpe_avg=3, eq_trainer="ls")
    pdata, pshift, pcorr = pchain(sharded.replicate_signal(p2.samples, mesh))
    pout = psig.get_data(frames=list(range(mesh.size))).replace(
        samples=torch.as_tensor(sharded.fetch_global(pdata, mesh), device=dev))
    res["pilot_ser"] = pout.cal_ser(synced=True).tolist()
    if rank == 0:
        print("EVM:", res["evm"])
        print("SER:", res["ser"])
        print("decimated SER:", res["decimated_ser"])
        print("sharded-prefix pilot SER:", res["pilot_ser"])
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(device=None, ranks=4, N=2 ** 16, frame_len=2 ** 14, timeout=900):
    """Start ``ranks`` gloo ranks of this script and return what rank 0 gathered."""
    from qampy_tpu_torch.utils import resolve_device
    dev = str(resolve_device(device))
    if dev.startswith("cuda"):
        import torch
        torch.empty(0, device=dev)      # no card: raise here, before any rank starts
    addr = "localhost:%d" % free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   str(ranks), addr, out, dev, str(N), str(frame_len)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env) for r in range(ranks)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(logs[0], end="")
        failed = [r for r, p in enumerate(procs) if p.returncode]
        if failed:
            raise RuntimeError("rank(s) %s failed:\n%s" % (failed, logs[failed[0]][-4000:]))
        with open(out) as f:
            return json.load(f)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        r_, n_, addr_, out_, dev_, N_, F_ = sys.argv[2:9]
        rank_main(int(r_), int(n_), addr_, out_, dev_, int(N_), int(F_))
    else:
        import argparse
        ap = argparse.ArgumentParser(description=__doc__)
        ap.add_argument("--device", default=None,
                        help="torch device; the card by default, 'cpu' for the CPU")
        ap.add_argument("--ranks", type=int, default=4)
        main(**vars(ap.parse_args()))
