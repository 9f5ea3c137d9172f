"""K3 (``sweep_masked_kernel``) in variants of its launch bound and of its
per-block choice of P, on the card.

The kernel as it stands (``shipped``: ``__launch_bounds__(256, 8)``, each
block the largest P <= 16 with ``n_live * P`` within 4 rounds of its 256
threads) is built beside:

- ``unbounded``: ``__launch_bounds__(256)``, ptxas free in its registers;
- ``one_round_cap32``: the largest P <= 32 with ``n_live * P <= 256``;
- ``rounds_2``: at most 2 rounds, P <= 16;
- ``rounds_4_cap32``: at most 4 rounds, P <= 32.

The script builds ``raytracingweekend_jl_tpu_torch/csrc/sweep.cu`` each way
(one ``nvcc -Xptxas -v`` each, in parallel) and prints each variant's
registers and spills. On the flagship gradient step's record states at
iterations 20 (about 62% of the lanes live) and 40 (about 5%), from
``chip_smoke.grad_kernel_phases``, it holds every run bit for bit against
the one-thread kernel (``sweep_fetch_one_thread``, the previous K10) and
times it with CUDA events: each variant at P
chosen per block, ``shipped`` also at fixed P = 1, 2, 4, 8 and 16, and
``unbounded`` at P = 1 and 16, in the order a, b, ..., b, a, twice. One
JSON object per line; a failed check raises.

    python3 scripts/torch_k3_variants.py     # one CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import raytracingweekend_jl_tpu_torch as pt  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    intersect_kernel as K)

BOUND = re.compile(r"__launch_bounds__\(RTW_SWEEP_THREADS(?:, *\d+)?\)"
                   r"(?=\s+sweep_masked_kernel\()")
CAP = re.compile(r"P = p_cap[^;]*;")
RULE = re.compile(r"while \(P > 1 && [^;]*\) P >>= 1;")


def _rule(rounds: int) -> str:
    return (f"while (P > 1 && n_live * P > {rounds} * RTW_SWEEP_THREADS) "
            f"P >>= 1;")


#: name -> {pattern: replacement} in sweep.cu
VARIANTS = {
    "shipped": {},
    "unbounded": {BOUND: "__launch_bounds__(RTW_SWEEP_THREADS)"},
    "one_round_cap32": {CAP: "P = p_cap;", RULE: _rule(1)},
    "rounds_2": {RULE: _rule(2)},
    "rounds_4_cap32": {CAP: "P = p_cap;"},
}
#: (variant, P) timed; P = 0 is the variant's per-block choice
RUNS = ([(name, 0) for name in VARIANTS]
        + [("shipped", p) for p in (1, 2, 4, 8, 16)]
        + [("unbounded", p) for p in (1, 16)])
PTXAS = re.compile(r"Function properties for \w*sweep_masked_kernel\w*\s+"
                   r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads\s+ptxas info\s*: Used (\d+) "
                   r"registers")


def variant_source(src: str, subs: dict) -> str:
    for pat in (BOUND, CAP, RULE):
        if len(pat.findall(src)) != 1:
            raise RuntimeError(f"{pat.pattern} not found once in sweep.cu")
    for pat, text in subs.items():
        src = pat.sub(lambda m: text, src)
    return src


def build_variants(out: str) -> dict:
    """``{name: ctypes library}`` of sweep.cu in each variant."""
    with open(os.path.join(build.CSRC_DIR, "sweep.cu")) as f:
        src = f.read()
    procs = {}
    for name, subs in VARIANTS.items():
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, subs))
        procs[name] = subprocess.Popen(
            [build._nvcc(), "-Xptxas", "-v", *build.NVCC_FLAGS, "-I",
             build.CSRC_DIR, "-shared", "-o", os.path.join(out, f"{name}.so"),
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        m = PTXAS.search(log)
        if m is None:
            raise RuntimeError(f"no ptxas report for K3 in {name}:\n{log}")
        stack, stores, loads, regs = map(int, m.groups())
        C.emit({"variant": name, "registers": regs, "stack_bytes": stack,
                "spill_store_bytes": stores, "spill_load_bytes": loads})
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        lib.rtw_sweep_masked.argtypes = build._SIGNATURES["rtw_sweep_masked"]
        lib.rtw_sweep_masked.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = C.card_line()
    print(card, flush=True)
    build.load()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    libs = build_variants(out)

    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    cam = pt.t_cam1(device=dev)
    _, _, _, snap = C.grad_kernel_phases(dev, card, scene, cam, 1920, 1080)
    spheres, amat = snap["spheres"], snap["amat"]
    n_sph = spheres.shape[0]

    def run(lib, r, a, parts):
        n = r.shape[1]
        t = torch.empty(n, dtype=torch.float32, device=dev)
        i = torch.empty(n, dtype=torch.int32, device=dev)
        err = lib.rtw_sweep_masked(
            r.data_ptr(), a.data_ptr(), spheres.data_ptr(), n, n_sph,
            float(K.DEFAULT_TMIN), t.data_ptr(), i.data_ptr(), parts,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "sweep_masked variant")
        return t, i

    for it, (r, a) in snap["k3_states"].items():
        r = r.contiguous()
        live = a != 0
        t10, i10, _ = K.sweep_fetch_one_thread(r, spheres, amat)
        t10 = torch.where(live, t10, torch.full_like(t10, K.BIG))
        i10 = torch.where(live, i10, torch.zeros_like(i10))
        for name, parts in RUNS:
            t, i = run(libs[name], r, a, parts)
            torch.cuda.synchronize()
            n_diff = int(C._bitwise_lanes([(t, t10), (i, i10)],
                                          r.shape[1]).sum())
            C.check(n_diff == 0, f"{name} P={parts} iteration {it}: "
                                 f"{n_diff} lanes differ from the "
                                 "one-thread kernel")
        ms = {}
        for _ in range(2):
            for name, parts in RUNS + RUNS[::-1]:
                ms.setdefault((name, parts), []).append(C.device_ms(
                    lambda: run(libs[name], r, a, parts), 20))
        for (name, parts), v in ms.items():
            C.emit({"iteration": it, "live_share": live.float().mean().item(),
                    "variant": name, "parts": parts or "per block",
                    "device_ms": v, "median_ms": statistics.median(v)})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
