"""The dry run's collectives, the port's against the reference's, on a
(2, 4) mesh of 8 devices.

The reference's come from ``tests/_torch_dryrun_ref.py`` in a process of
its own (8 host devices; ``parse_collective_bytes`` of the compiled
HLO); the port's from ``Cell.lower`` on DTensor arguments over a
``"fake"`` process group of 8 ranks.  Prints one JSON line per program:
both breakdowns (result bytes per device by op) and the ratio of the
totals.  LM cells run at 1 layer.

Usage:
    PYTHONPATH=src python tools/torch_dryrun_collectives.py \\
        smollm-360m:train_4k dlrm-rm2:serve_p99
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def port(names):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import Cell
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_mesh
    B, D, F = 64, 256, 512                    # tests/_torch_dryrun_ref.py's

    def meta(*shape):
        return torch.empty(*shape, device="meta")
    out = {}
    with fake_process_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        block = Cell("block", "block", "serve",
                     lambda x, w1, w2: (x @ w1) @ w2,
                     (meta(B, D), meta(D, F), meta(F, D)),
                     (lambda m, r: ("data",), lambda m, r: (None, "model"),
                      lambda m, r: ("model",)),
                     out_spec_trees=(lambda m, r: ("data",),))
        out["block"] = block.lower(mesh).collectives
        for name in names:
            arch, shape = name.split(":")
            a = get_arch(arch)
            cell = a.cell(shape, cfg_overrides={"n_layers": 1}) \
                if a.family == "lm" else a.cell(shape)
            out[name] = cell.lower(mesh).collectives
    return out


def main(names):
    ref = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_ref.py"),
         *names], env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                           JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, check=True)
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    got = port(names)
    for name in ["block", *names]:
        print(json.dumps({"program": name, "reference": want[name],
                          "port": got[name],
                          "port/reference": got[name]["total"]
                          / want[name]["total"]}))


if __name__ == "__main__":
    main(sys.argv[1:])
