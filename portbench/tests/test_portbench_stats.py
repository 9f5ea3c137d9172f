"""The statistics that decide ``correct`` and the host-clock percentile."""

import pytest
import torch

from portbench.harness import stats


def test_percentile():
    xs = [float(x) for x in range(1, 101)]
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_block_sums_cover_each_block_once():
    W, H = 8, 6
    x = torch.arange(W * H, dtype=torch.float64)[:, None].repeat(1, 3)
    b = stats.block_sums(x, W, H, (4, 3))
    assert b.shape == (12, 3)
    assert float(b.sum()) == pytest.approx(3 * float(x[:, 0].sum()))
    # block (row 0, col 0) holds pixels 0, 1, 8, 9
    assert float(b[0, 0]) == 0 + 1 + 8 + 9
    with pytest.raises(ValueError):
        stats.block_sums(x, W, H, (3, 3))


def test_image_z_is_calibrated_on_samples_of_one_law():
    """The program and the reference draw from one law: the z of each block
    has mean near 0 and variance near 1."""
    g = torch.Generator().manual_seed(0)
    W, H, S, J = 40, 30, 16, 4
    mu = torch.rand((W * H, 3), generator=g, dtype=torch.float64)

    def draw(n):
        return mu + 0.3 * torch.randn((n, W * H, 3), generator=g,
                                      dtype=torch.float64)

    zs = []
    for _ in range(20):
        calls = draw(S)
        c, j = draw(1)[0], draw(J)
        ref = dict(centered=c, mean=j.mean(0), var=j.var(0),
                   paths=W * H * (J + 1))
        zs.append(stats.image_z(calls.sum(0), (calls * calls).sum(0), S, S,
                                1, ref, W, H, (10, 10)))
    z = torch.cat(zs).ravel()
    assert abs(float(z.mean())) < 0.1
    assert 0.8 < float(z.var()) < 1.25


def test_image_z_sees_a_shift():
    W, H, J = 20, 20, 4
    ref = dict(centered=torch.full((W * H, 3), 0.5, dtype=torch.float64),
               mean=torch.full((W * H, 3), 0.5, dtype=torch.float64),
               var=torch.full((W * H, 3), 0.01, dtype=torch.float64),
               paths=W * H * (J + 1))
    prog = torch.full((W * H, 3), 0.5 * 8)
    sq = prog * prog / 8
    assert float(stats.image_z(prog, sq, 8, 8, 1, ref, W, H,
                               (2, 2)).abs().max()) < 1e-6
    prog[:100] *= 2.0
    sq[:100] *= 4.0
    assert float(stats.image_z(prog, sq, 8, 8, 1, ref, W, H,
                               (2, 2)).abs().max()) > 6


def test_image_z_floors_a_block_of_no_variance():
    """One bright path that the reference never drew is a few standard
    errors, not infinitely many."""
    W, H, J, S = 10, 10, 4, 40
    zero = torch.zeros((W * H, 3), dtype=torch.float64)
    ref = dict(centered=zero, mean=zero, var=zero, paths=W * H * (J + 1))
    prog = torch.zeros((W * H, 3))
    prog[3, 2] = 1.0
    assert float(stats.image_z(prog, prog * prog, S, S, 1, ref, W, H,
                               (1, 1)).abs().max()) < 1.0


def test_image_z_takes_the_rare_paths_the_reference_missed_from_the_program():
    """Paths of 1 in one sample of 1 000 that the reference's samples never
    drew: its variance alone (the floor) reads the program's mean as 16
    standard errors off, with the program's own about 4."""
    g = torch.Generator().manual_seed(2)
    W, H, J, S = 16, 16, 64, 20000
    zero = torch.zeros((W * H, 3), dtype=torch.float64)
    ref = dict(centered=zero, mean=zero, var=zero, paths=W * H * (J + 1))
    calls = (torch.rand((S, W * H, 3), generator=g) < 1e-3).float()
    z = stats.image_z(calls.sum(0), (calls * calls).sum(0), S, S, 1, ref, W,
                      H, (1, 1))
    assert float(z.abs().max()) < 8.0


def test_welch_z():
    g = torch.Generator().manual_seed(1)
    a = torch.randn((200, 50), generator=g, dtype=torch.float64)
    b = torch.randn((30, 50), generator=g, dtype=torch.float64)
    z = stats.welch_z(a.sum(0), (a * a).sum(0), 200, b.sum(0),
                       (b * b).sum(0), 30)
    assert 0.5 < float((z * z).mean()) < 1.6
    z = stats.welch_z(a.sum(0) + 400, (a * a + 4 * a + 4).sum(0), 200,
                       b.sum(0), (b * b).sum(0), 30)
    assert float((z * z).mean()) > 20
    zero = torch.zeros(2, dtype=torch.float64)
    z = stats.welch_z(torch.tensor([0.0, 1.0], dtype=torch.float64),
                       torch.tensor([0.0, 1.0], dtype=torch.float64) / 1,
                       1, zero, zero, 1)
    assert float(z[0]) == 0.0 and float(z[1]) == float("inf")
