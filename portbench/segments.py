#!/usr/bin/env python3
"""Measure a configuration's segments per path (the sweeps a path takes)
with the plain reference, for its ``segments_per_path``:

    python3 portbench/segments.py --config book1_final --width 384 --spp 8

prints one JSON line: the configuration, the film, the samples, the seed,
the paths, the segments and their ratio. Runs on the card when there is
one, else on the CPU.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench.harness.seeds import generator  # noqa: E402
from portbench.harness.spec import PKG, load_json  # noqa: E402
from portbench.reference.camera import camera_arrays, camera_tensors  # noqa: E402
from portbench.reference.scene import scene_arrays, scene_tensors  # noqa: E402
from portbench.reference.tracer import render_stats  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--spp", type=int, default=8,
                   help="jittered samples a pixel, besides sample 0")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    cfg = load_json(PKG, "configs", a.config + ".json")
    W, H = a.width, a.width * 9 // 16
    st = render_stats(scene_tensors(scene_arrays(cfg["scene"]), torch.float32,
                                    dev),
                      camera_tensors(camera_arrays(cfg["camera"]),
                                     torch.float32, dev),
                      W, H, generator(a.seed, "segments", dev), a.spp,
                      cfg["max_depth"], cfg["tmin"])
    print(json.dumps({"config": a.config, "film": [W, H], "spp": a.spp + 1,
                      "seed": a.seed, "device": dev, "paths": st["paths"],
                      "segments": st["segments"],
                      "segments_per_path": st["segments"] / st["paths"]}))


if __name__ == "__main__":
    main()
