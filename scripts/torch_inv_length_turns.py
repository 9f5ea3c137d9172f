"""The kernels that normalise a direction, before and after the
normalisation was rounded once, timed in turns on the card.

    python3 scripts/torch_inv_length_turns.py [--turns 2]

Builds the kernel library three times: ``shipped`` from the sources as
they are (every direction through ``rtw_inv_length``: the correctly
rounded ``__frsqrt_rn``), ``double`` from a copy whose ``rtw_inv_length``
takes the plain version's route (the square root and division in double,
then one rounding to float: the same bits, another cost) and ``former``
from a copy rewritten to the normalisation before the repair
(``torch_strided_gap_probe.FORMER_NORMALISATION``: the scatter directions
by the approximate ``rsqrtf``, the camera ray by a float square root then
a float division). Then times K2, K4, K5, K7a,
K7c, K8, K9, K11 and K12, each at shapes of its main path, and K1 (which
normalises nothing) beside them, through each library's own launcher, by
``chip_smoke.batch_ms`` (one CUDA event pair around N launches behind a
spin kernel, each launch on its own copy of the state; the profiler's
mean per launch): former, double, shipped in the first turn, the reverse
in the second, and so on. Prints one JSON line per kernel and shape with
every turn's times and the ratios of the medians to former's, then the
card's name and power limit.

The shapes: K1 and K2 at iteration 24 of the flagship render (32 400
lanes, k = 64); K4 and K11 at iteration 20 of the flagship step's record
(262 144 lanes); K5 over its first phase; K9 and K12 at iterations 8 and
24 of the flagship film pinned (2 073 600 lanes); K7a at bounces 0 and 8
of the inverse demo's first pass, K7c over its walk and K8 over its
forward render (the ``scripts/torch_k*_variants.py`` states).
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import torch_k2_k4_variants as V24  # noqa: E402
import torch_k5_k6_variants as V56  # noqa: E402
import torch_k7a_k8_variants as V78  # noqa: E402
import torch_k7c_k11_variants as V711  # noqa: E402
import torch_k9_k13_variants as V913  # noqa: E402
import torch_k10_k12_variants as V1012  # noqa: E402
import torch_strided_gap_probe as P  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK  # noqa: E402,E501


#: ``rtw_inv_length`` by the plain version's route.
DOUBLE_NORMALISATION = (
    ("shade_core.cuh", P.INV_LENGTH,
     "  return __double2float_rn(\n"
     "      __ddiv_rn(1.0, __dsqrt_rn((double)fmaxf(x, 1e-20f))));\n"),)


def k1_launch(lib, rays, spheres, t, idx) -> None:
    err = lib.rtw_sweep(rays.data_ptr(), spheres.data_ptr(), rays.shape[1],
                        spheres.shape[0], 1e-4, t.data_ptr(), idx.data_ptr(),
                        8, torch.cuda.current_stream().cuda_stream)
    build.check(err, "K1")


def cases(dev) -> dict:
    """``{name: (launch(lib, *args), make_args, n, kernel regex)}``."""
    out = {}
    fwd, snap = V24.states(dev)
    rays, spheres = fwd["rays"], fwd["spheres"]
    t_out = torch.empty_like(fwd["t"])
    i_out = torch.empty_like(fwd["idx"])
    out["K1/mid_render_32400"] = (
        lambda lib: k1_launch(lib, rays, spheres, t_out, i_out),
        lambda: (), 50, r"\bsweep_kernel\b")
    out["K2/mid_render_32400"] = (
        lambda lib, fs, is_, buf: V24.k2_launch(
            lib.rtw_shade_strided, fs, is_, buf, fwd["t"], fwd["idx"],
            fwd["amat"], fwd["cc"], fwd["geom"], fwd["seed"], 24),
        lambda: [x.clone() for x in fwd["state"]], 50, V24.K2_RE)
    sf, si, rad = snap["k4_states"][20]
    t4, i4 = snap["k4_hits"][20]
    out["K4/record_it20"] = (
        lambda lib, sf_, si_, rad_, slot: V24.k4_launch(
            lib.rtw_persist_record, t4, i4, fwd["amat"], snap["strips"], sf_,
            si_, rad_, slot, snap["seed"], 20, snap["depth"]),
        lambda: [sf.clone(), si.clone(), rad.clone(),
                 torch.empty((PK.N_REC, sf.shape[1]), device=dev)],
        20, V24.K4_RE)
    ph = V56.phases(dev)
    p1 = ph["phase1"]
    out["K5/phase1"] = (
        lambda lib, cot, dep, dattr: V56.k5_launch(
            lib.rtw_persist_replay_fused, cot, dep, p1["rec"], p1["gs"],
            dattr, p1["i0"], V56.SEED),
        lambda: (p1["cot"].clone(), p1["dep"].clone(),
                 torch.empty((p1["rec"].shape[0], 9, p1["rec"].shape[2]),
                             device=dev)), 10,
        V56.K5_RE)
    k7 = V78.k7a_states(dev)
    for b in (0, 8):
        bx = k7["bounces"][b]
        out[f"K7a/demo_bounce{b}"] = (
            lambda lib, st, slot, bx=bx, b=b: V78.k7a_launch(
                lib.rtw_record_shade, bx["t"], bx["idx"], k7["amat"], st,
                slot, b),
            lambda bx=bx: (bx["st"].clone(), torch.empty(
                (GK.N_REC, bx["st"].shape[1]), device=dev)), 50,
            V78.K7A_RE)
    demo = V78.k8_shapes(dev)["demo"]
    R = demo["rays"].shape[1]
    out["K8/demo"] = (
        lambda lib, rad, head: V78.k8_launch(lib.rtw_inline, demo, rad,
                                             head),
        lambda: (torch.empty((3, R), device=dev),
                 torch.zeros(1, dtype=torch.int32, device=dev)), 20,
        V78.K8_RE)
    rec, g3, seed7c = V711.k7c_states(dev)["fit_22400"]
    group = GK.replay_group(rec.shape[2], GK._resident_threads(dev))
    out["K7c/fit_22400"] = (
        lambda lib, cot, dattr: V711.k7c_launch(
            lib.rtw_replay_bwd_fused, rec, g3, cot, dattr, seed7c, group),
        lambda: (torch.zeros((9, rec.shape[2]), device=dev),
                 torch.empty((rec.shape[0], 9, rec.shape[2]), device=dev)),
        50, V711.K7C_RE)
    k11 = V711.k11_states(dev)
    sf11, si11, rad11, _ = k11["at"][20]
    out["K11/record_it20"] = (
        lambda lib, sf_, si_, rad_, slot, idx: V711.k11_launch(
            lib.rtw_persist_record_fused, k11, 20, sf_, si_, rad_, slot,
            idx),
        lambda: V711.k11_outputs(sf11, si11, rad11), 20, V711.K11_RE)
    scene, cam, sph, amat = V1012.flagship(dev)
    pin = V1012.k12_states(dev, scene, cam, sph, amat)
    sweeps = V913.k9_sweeps(pin)
    for it in (8, 24):
        fs, ist, _ = pin["at"][it]
        t9, i9 = sweeps[it]
        make = lambda fs=fs, ist=ist: (fs.clone(), ist.clone())
        out[f"K9/pinned_it{it}"] = (
            lambda lib, f, i, t9=t9, i9=i9, it=it: V913.k9_launch(
                lib.rtw_shade_pinned_fetch, pin, f, i, t9, i9, it),
            make, 30, V913.K9_RE)
        out[f"K12/pinned_it{it}"] = (
            lambda lib, f, i, it=it: V1012.k12_launch(lib.rtw_mega, pin, f,
                                                      i, it),
            make, 20, r"\bmega_kernel\b")
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    build.load()
    work = tempfile.mkdtemp()
    try:
        libs = {name: P.load_library(
                    P.rewritten_csrc(os.path.join(work, name), rewrites),
                    os.path.join(work, name, "kernels"))
                for name, rewrites in (("former", P.FORMER_NORMALISATION),
                                       ("double", DOUBLE_NORMALISATION))}
        libs["shipped"] = build.load()
        table = cases(dev)
        times = {name: {b: [] for b in libs} for name in table}
        for turn in range(args.turns):
            order = list(libs) if turn % 2 == 0 else list(libs)[::-1]
            for name, (launch, make, n, pat) in table.items():
                for b in order:
                    r = C.batch_ms(lambda *a, lib=libs[b]: launch(lib, *a),
                                   make, n, pat)
                    times[name][b].append(r)
        for name, by in times.items():
            med = {b: statistics.median(r["event_ms"] for r in rs)
                   for b, rs in by.items()}
            print(json.dumps({
                "kernel": name, "event_ms": {b: [r["event_ms"] for r in rs]
                                             for b, rs in by.items()},
                "profiler_ms": {b: [r["profiler_ms"] for r in rs]
                                for b, rs in by.items()},
                "median_event_ms": med,
                "over_former": {b: med[b] / med["former"] for b in med}}),
                flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
