"""Multi-pod dry run: every (arch × shape × mesh) cell on the meta device.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell through XLA on 512 placeholder host devices; the
port runs each cell's step once on the ``meta`` device (shapes and
dtypes, no memory, no card) under a production mesh's sharding rules
(``Cell.lower``), and turns the counts into a ``RooflineReport``.  It is
the one entry point of the port that touches no card, by design.

The meshes are ``DeviceMesh`` objects over a ``torch.distributed``
process group with the ``"fake"`` backend at the mesh's world size (256
or 512 ranks; this process is rank 0).  ``main()`` sets the group up
and tears it down, one mesh size at a time; importing this module sets
up nothing and sets no environment variable.  The fake backend's store
comes from ``torch.testing._internal.distributed.fake_pg``, which is
PyTorch's internal API.

Per record: FLOPs from ``FlopCounterMode`` (every layer is run, so no
layer correction), bytes accessed as the sum of every aten op's operand
and result bytes, both divided by the mesh size (the ideal partition,
where XLA's figures are those of the partitioned program); argument
bytes per device exact from the rules; the compute and memory terms with
the H100 constants of ``launch.roofline``; the collective term ``None``
(not derived).

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod both \\
        --out results/dryrun_torch.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
from typing import Iterator, Optional, Tuple

__all__ = ["fake_process_group", "run_cell", "main"]

_AXES = ("pod", "data", "model")


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A ``"fake"``-backend process group of ``world_size`` ranks (this
    process rank 0), destroyed on exit."""
    import torch.distributed as dist
    # PyTorch's internal API: the store the fake backend is tested with
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_shape(multi_pod: bool,
                mesh_shape: Optional[Tuple[int, ...]]) -> Tuple[int, ...]:
    if mesh_shape is not None:
        return tuple(mesh_shape)
    return (2, 16, 16) if multi_pod else (16, 16)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             rules=None, verbose: bool = True, cfg_overrides=None,
             opt_cfg=None, mesh_shape=None, counted: Optional[dict] = None):
    """One cell's ``RooflineReport`` on the production mesh (or the
    elastic ``mesh_shape``).  Needs a process group of the mesh's size
    (``fake_process_group``).  ``counted`` maps (arch, shape) to a
    ``Lowered`` of an earlier mesh, whose counts the cell reuses (they
    do not depend on the mesh); the cell's own is added to it."""
    from ..configs import get_arch
    from ..distrib.shardings import ShardingRules
    from .mesh import make_mesh, make_production_mesh
    from .roofline import analyze_lowered, model_flops_for

    arch = get_arch(arch_name)
    kw = {}
    if cfg_overrides and arch.family == "lm":
        kw["cfg_overrides"] = cfg_overrides
    if opt_cfg is not None and arch.family == "lm":
        kw["opt_cfg"] = opt_cfg
    cell = arch.cell(shape_name, **kw)
    if mesh_shape is not None:
        # elastic factorization, e.g. (4, 8, 16) or (8, 32)
        mesh = make_mesh(tuple(mesh_shape), _AXES[-len(mesh_shape):],
                         device_type="cpu")
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    mesh_name = "x".join(str(s) for s in mesh.shape)
    rules = rules or ShardingRules()

    key = (arch_name, shape_name)
    lowered = cell.lower(mesh, rules, counted=(counted or {}).get(key))
    if counted is not None:
        counted.setdefault(key, lowered)
    rep = analyze_lowered(
        lowered, arch=arch_name, shape=shape_name, mesh_name=mesh_name,
        n_devices=mesh.size(), kind=cell.kind,
        model_flops_global=model_flops_for(arch, shape_name),
        compile_s=lowered.seconds, notes=cell.notes)
    if verbose:
        print(f"--- {arch_name} × {shape_name} on {mesh_name} (meta run "
              f"{lowered.seconds:.1f}s): flops {lowered.flops:.4g}, bytes "
              f"{lowered.bytes_accessed:.4g}, argument bytes per device "
              f"{lowered.argument_bytes:,}")
        print(rep.summary())
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch × shape) cell")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--mesh", default=None,
                    help="elastic mesh factorization, e.g. 4x8x16 "
                         "(pods x data x model); overrides --multi-pod")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import all_cells, get_arch

    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in get_arch(args.arch).shape_names()]
    else:
        ap.error("need --arch [--shape] or --all")

    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) \
        if args.mesh else None
    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    if mesh_shape is not None:
        pods = [False]

    out_f = open(args.out, "a") if args.out else None
    failures, counted = [], {}
    try:
        # one process group per mesh size: a group's world size is fixed
        for mp in pods:
            with fake_process_group(math.prod(_mesh_shape(mp, mesh_shape))):
                for arch_name, shape_name in cells:
                    t0 = time.perf_counter()
                    try:
                        rep = run_cell(arch_name, shape_name, mp,
                                       verbose=not args.quiet,
                                       mesh_shape=mesh_shape,
                                       counted=counted)
                    except Exception as e:      # recorded, reported at exit
                        traceback.print_exc()
                        failures.append((arch_name, shape_name, mp,
                                         repr(e)))
                        continue
                    rep.compile_s = time.perf_counter() - t0
                    if out_f:
                        out_f.write(json.dumps(rep.to_dict()) + "\n")
                        out_f.flush()
    finally:
        if out_f:
            out_f.close()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"\nall {len(cells) * len(pods)} cells ran OK on the meta device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
