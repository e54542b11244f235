"""The generators: made from the seed, with the statistics of the port's own generators."""
import math

import numpy as np
import pytest
import torch

from benchmark.gen import blind_tx, pilot_tx, seeds


def out_of_band(planes, fb, beta, os=2):
    """Share of the power above the root-raised-cosine band, (1 + beta) fb / 2."""
    z = torch.complex(planes[:2], planes[2:]).to(torch.complex128)
    S = torch.fft.fft(z, dim=-1).abs() ** 2
    f = torch.fft.fftfreq(z.shape[-1], d=1 / (os * fb)).abs()
    return float(S[:, f > (1 + beta) * fb / 2].sum() / S.sum())


def test_blind_capture_from_the_seed():
    a = blind_tx.make(2 ** 13, seed=seeds.part(2 ** 31 + 3, 0), device="cpu")
    b = blind_tx.make(2 ** 13, seed=seeds.part(2 ** 31 + 3, 0), device="cpu")
    c = blind_tx.make(2 ** 13, seed=seeds.part(2 ** 31 + 3, 1), device="cpu")
    assert a.planes.shape == (4, 2 ** 14) and a.planes.dtype == torch.float32
    assert torch.equal(a.planes, b.planes) and torch.equal(a.idx, b.idx)
    assert not torch.equal(a.planes, c.planes)
    assert a.idx.shape == (2, 2 ** 13) and int(a.idx.max()) < 64
    assert float((a.const.abs() ** 2).mean()) == pytest.approx(1.0, rel=1e-6)


def test_blind_statistics_match_the_ports_generator():
    from qampy_tpu_torch.workload import make_tx
    n = 2 ** 15
    ours = blind_tx.make(n, seed=5, device="cpu")
    sig, syms, _ = make_tx(n, seed=5)
    theirs = torch.as_tensor(np.concatenate([sig.real, sig.imag]).astype(np.float32))
    p_ours = (ours.planes[:2] ** 2 + ours.planes[2:] ** 2).mean(-1)
    p_theirs = (theirs[:2] ** 2 + theirs[2:] ** 2).mean(-1)
    assert p_ours.numpy() == pytest.approx(p_theirs.numpy(), rel=0.03)
    # 35 dB of noise over the whole band: what lies above the shaped band is noise
    oob = out_of_band(ours.planes, 25e9, 0.1)
    assert oob == pytest.approx(out_of_band(theirs, 25e9, 0.1), rel=0.2)
    assert oob < 1e-3
    # the symbols are drawn uniformly
    counts = torch.bincount(ours.idx.reshape(-1).long(), minlength=64).double()
    assert float(counts.min()) > 0.8 * counts.mean() and float(counts.max()) < 1.2 * counts.mean()


def test_gray_mapping():
    coded, bits = pilot_tx.gray_mapping(64)
    assert float(np.mean(np.abs(coded) ** 2)) == pytest.approx(1.0, rel=1e-6)
    d = np.abs(coded[:, None] - coded[None, :])
    dmin = d[d > 1e-6].min()
    near = np.argwhere(np.abs(d - dmin) < 1e-6)
    assert all((bits[i] != bits[j]).sum() == 1 for i, j in near)


def test_pilot_capture_layout_and_statistics():
    from qampy_tpu_torch.workload import make_pilot_tx
    F, seq, R = 2 ** 14, 512, 32
    dat, pil = pilot_tx.pilot_layout(F, seq, R)
    assert int(pil.sum()) == seq + (F - seq) // R and int(dat.sum()) == F - int(pil.sum())
    pilots = pilot_tx.draw_pilots(7, F, seq, R, device="cpu")
    assert pilots.seq.shape == (2, seq) and pilots.phase.shape == (2, (F - seq) // R)
    a = pilot_tx.make(pilots, 3, seed=8, frame_len=F, seq_len=seq, ins_rat=R, device="cpu")
    b = pilot_tx.make(pilots, 3, seed=8, frame_len=F, seq_len=seq, ins_rat=R, device="cpu")
    assert a.planes.shape == (4, 3 * F * 2) and torch.equal(a.planes, b.planes)
    assert a.idx.shape == (2, int(dat.sum()))
    theirs = make_pilot_tx(3, frame_len=F, seq_len=seq, seed=8, device="cpu")
    p = (a.planes[:2] ** 2 + a.planes[2:] ** 2).mean(-1)
    q = (theirs.planes[:2] ** 2 + theirs.planes[2:] ** 2).mean(-1)
    assert p.numpy() == pytest.approx(q.numpy(), rel=0.03)
    assert out_of_band(a.planes, 24e9, 0.1) == pytest.approx(
        out_of_band(theirs.planes, 24e9, 0.1), rel=0.3)


def test_seed_parts_are_distinct_and_fit_a_generator():
    big = 2 ** 31 + 12345
    parts = {seeds.part(big, k) for k in range(-1, 10)}
    assert len(parts) == 11 and max(parts) < 2 ** 63
    torch.Generator().manual_seed(seeds.part(2 ** 62, 3))
    assert math.isfinite(seeds.part(big, 0))
