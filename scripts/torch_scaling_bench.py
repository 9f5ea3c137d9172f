"""Weak scaling of the port's sharded render over world sizes — the
counterpart of ``scripts/scaling_bench.py``.

Each rank renders a flagship film's worth of tiles
(``scene_random_spheres(seed=1)``, ``t_cam1``, 254 tiles of the sharded
driver's 8 192 pixels: the film 1920 x 1080 n at n ranks) at spp 4,
``persistent=True`` (the strided route per tile), and rank 0 prints one
JSON line per world size with the throughput, the throughput per rank,
the parallel efficiency against one rank (per-rank throughput over one
rank's), and the card's name and power limit (``nvidia-smi``).

``--rehearsal`` takes the reference script's share instead (8 tiles of
4 096 pixels a rank at 256 rows): ~0.13 Mpaths a rank, a render of a few
tens of milliseconds, so its numbers measure host launch overhead, not
the card or the collectives. It rehearses the launch, e.g. on the CPU.

    torchrun --nproc-per-node 4 scripts/torch_scaling_bench.py
        one line, at the launch's world size (NCCL, one card per rank)
    python scripts/torch_scaling_bench.py [--max-ranks N] [--device cpu]
        one line per world size 1, 2, 4, ... up to N (default: the CUDA
        devices), each a launch of its own: this process starts the ranks
        (one card each, ``LOCAL_RANK``) on a ``file://`` rendezvous

``--device cpu`` runs the ranks on the CPU over gloo (with
``--rehearsal``: the flagship share takes minutes a sample there), whose
numbers measure the host's cores, not a card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SPP = 4
#: A rank's share: the flagship film; the reference script's share.
FILM = (1920, 1080)
REHEARSAL_TILE, REHEARSAL_TILES, REHEARSAL_HEIGHT = 4096, 8, 256


def film(n: int, rehearsal: bool) -> tuple[int, int, int]:
    """``(width, height, tile_size)`` of the render at ``n`` ranks."""
    if rehearsal:
        return (n * REHEARSAL_TILES * REHEARSAL_TILE // REHEARSAL_HEIGHT,
                REHEARSAL_HEIGHT, REHEARSAL_TILE)
    from raytracingweekend_jl_tpu_torch.parallel.shard import DEFAULT_TILE
    W, H = FILM
    return W, H * n, DEFAULT_TILE


def card_line() -> str:
    """``name, power limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(device: str | None, rehearsal: bool,
            runs: int = 3) -> dict | None:
    """This rank's part of one world size; rank 0's line (else None)."""
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.parallel import multihost
    from raytracingweekend_jl_tpu_torch.parallel.shard import (
        render_radiance_sharded)

    multihost.initialize(backend="gloo" if device == "cpu" else None)
    mesh = multihost.make_multihost_mesh(1, device=device)
    n = mesh.size
    W, H, tile = film(n, rehearsal)
    scene, cam = pt.scene_random_spheres(seed=1), pt.t_cam1()

    def render(seed):
        out = render_radiance_sharded(scene, cam, W, SPP, mesh=mesh,
                                      image_height=H, tile_size=tile,
                                      seed=seed, persistent=True)
        float(out.sum())  # the copy to the host is the sync
        return out

    render(0)  # warm-up
    walls = []
    for r in range(runs):
        mesh.barrier()
        t0 = time.perf_counter()
        render(r + 1)
        walls.append(time.perf_counter() - t0)
    mesh.barrier()
    if mesh.rank != 0:
        return None
    wall = sorted(walls)[len(walls) // 2]
    mpaths = W * H * SPP / wall / 1e6
    on_card = mesh.device.type == "cuda"
    return {"ranks": n, "rehearsal": rehearsal, "image": f"{W}x{H}x{SPP}",
            "tile_size": tile,
            "backend": (torch.distributed.get_backend()
                        if mesh.distributed else None),
            "device": (torch.cuda.get_device_name(mesh.device) if on_card
                       else "cpu (rehearsal: not a device measurement)"),
            "card": card_line() if on_card else None,
            "wall_s_runs": walls, "wall_s_median": wall,
            "mpaths_per_s": mpaths, "mpaths_per_s_per_rank": mpaths / n}


def launch(n: int, argv: list, timeout: int) -> dict:
    """Start ``n`` ranks of this script at once; rank 0's line."""
    rdzv = tempfile.mkdtemp(prefix="rtw_scaling_")
    env = {**os.environ, "RTW_INIT_METHOD": f"file://{rdzv}/store",
           "WORLD_SIZE": str(n)}
    args = [sys.executable, os.path.abspath(__file__), "--rank-of-launch",
            *argv]
    procs = [subprocess.Popen(args, env={**env, "RANK": str(r),
                                         "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode:
                raise RuntimeError(f"a rank of {n} failed:\n{err[-2000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return json.loads(outs[0].strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-ranks", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' for a gloo rehearsal on the CPU")
    ap.add_argument("--rehearsal", action="store_true",
                    help="the reference script's toy share per rank")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--rank-of-launch", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    from raytracingweekend_jl_tpu_torch.parallel import multihost
    if args.rank_of_launch or multihost.cluster_env_hint():
        line = measure(args.device, args.rehearsal)
        if line is not None:
            print(json.dumps(line), flush=True)
        return
    import torch
    max_ranks = args.max_ranks or (1 if args.device == "cpu"
                                   else torch.cuda.device_count())
    if max_ranks < 1:
        raise SystemExit("no CUDA device: pass --device cpu for a CPU "
                         "rehearsal")
    argv = ["--rehearsal"] if args.rehearsal else []
    if args.device:
        argv += ["--device", args.device]
    base = None
    n = 1
    while n <= max_ranks:
        line = launch(n, argv, args.timeout)
        base = base or line["mpaths_per_s_per_rank"]
        line["parallel_efficiency"] = line["mpaths_per_s_per_rank"] / base
        print(json.dumps(line), flush=True)
        n *= 2


if __name__ == "__main__":
    main()
