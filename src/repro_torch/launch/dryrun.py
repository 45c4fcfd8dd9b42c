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
and tears it down for each cell and mesh in turn, in this process or,
with ``--jobs N``, in N spawned processes, one cell at a time each;
importing this module sets up nothing and sets no environment
variable.  The fake backend's store
comes from ``torch.testing._internal.distributed.fake_pg``, which is
PyTorch's internal API.

Per record: FLOPs from ``FlopCounterMode`` (every layer is run, so no
layer correction) and bytes accessed as the sum of every aten op's
operand and result bytes, both from a run on plain meta tensors, divided
by the mesh size (the ideal partition, where XLA's figures are those of
the partitioned program); argument bytes per device exact from the
rules; one device's peak bytes of live storage and its collectives (the
result bytes of each ``c10d_functional`` collective, by XLA's op name)
from a second run on DTensor arguments on the mesh; the compute, memory
and collective terms with the H100 constants of ``launch.roofline``.  A
cell whose collectives or peak cannot be derived fails, and the run
exits 1.  The redistributions the models make beyond the rules (a head
count the model axis does not divide, the MoE dispatch on replicas) are
named in the record's ``notes``.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod both \\
        --out results/dryrun_torch.jsonl --jobs 8
    python -m repro_torch.launch.dryrun --all --family gnn,recsys \\
        --mesh 1x1        # one device: peaks to hold against a card
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
from dataclasses import replace
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
    ``Lowered`` of an earlier mesh, whose FLOPs and bytes the cell
    reuses (they do not depend on the mesh; its peak and collectives
    do, and are derived anew); the cell's own is added to it."""
    from ..configs import get_arch
    from ..configs.base import lm_device_terms
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
    lm = arch.family == "lm"
    lowered = cell.lower(mesh, rules, counted=(counted or {}).get(key),
                         distributed=not lm)
    if counted is not None:
        counted.setdefault(key, lowered)
    if lm:      # from the runs at 2 and 3 layers (exact by linearity)
        t0 = time.perf_counter()
        lowered = replace(lowered)
        lowered.peak_bytes, lowered.collectives, lowered.notes = \
            lm_device_terms(arch, shape_name, mesh, rules, **kw)
        lowered.seconds += time.perf_counter() - t0
    rep = analyze_lowered(
        lowered, arch=arch_name, shape=shape_name, mesh_name=mesh_name,
        n_devices=mesh.size(), kind=cell.kind,
        model_flops_global=model_flops_for(arch, shape_name),
        compile_s=lowered.seconds,
        notes="; ".join(n for n in (cell.notes, lowered.notes) if n))
    if verbose:
        print(f"--- {arch_name} × {shape_name} on {mesh_name} (meta runs "
              f"{lowered.seconds:.1f}s): flops {lowered.flops:.4g}, bytes "
              f"{lowered.bytes_accessed:.4g}, argument bytes per device "
              f"{lowered.argument_bytes:,}, peak bytes per device "
              f"{lowered.peak_bytes:,}, collective bytes per device "
              f"{lowered.collectives['total']:,}")
        print(rep.summary())
    return rep


def _cell_records(arch_name: str, shape_name: str, pods, mesh_shape,
                  verbose: bool) -> dict:
    """{multi_pod: (record dict, None) or (None, the error's repr)} of
    one cell on each mesh, a fake process group of its size set up for
    each in turn; the FLOPs and bytes are counted once."""
    out, counted = {}, {}
    for mp in pods:
        with fake_process_group(math.prod(_mesh_shape(mp, mesh_shape))):
            t0 = time.perf_counter()
            try:
                rep = run_cell(arch_name, shape_name, mp, verbose=verbose,
                               mesh_shape=mesh_shape, counted=counted)
            except Exception as e:          # recorded, reported at exit
                traceback.print_exc()
                out[mp] = (None, repr(e))
                continue
            rep.compile_s = time.perf_counter() - t0
            out[mp] = (rep.to_dict(), None)
    return out


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
                         "(pods x data x model) or 1x1 (data x model, "
                         "one device); overrides --multi-pod")
    ap.add_argument("--family", default=None,
                    help="with --all: only these families, e.g. gnn,recsys")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run in this many processes at once")
    args = ap.parse_args(argv)

    from ..configs import all_cells, get_arch

    if args.all:
        fams = set(args.family.split(",")) if args.family else None
        cells = [c for c in all_cells()
                 if fams is None or get_arch(c[0]).family in fams]
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

    work = [(a, s_, pods, mesh_shape, not args.quiet) for a, s_ in cells]
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            done = list(pool.map(_cell_records, *zip(*work)))
    else:
        done = [_cell_records(*w) for w in work]
    failures = []
    with open(args.out, "a") if args.out else contextlib.nullcontext() \
            as out_f:
        for mp in pods:             # the records mesh by mesh, in order
            for (arch_name, shape_name), runs in zip(cells, done):
                rec, err = runs[mp]
                if err is not None:
                    failures.append((arch_name, shape_name, mp, err))
                elif out_f:
                    out_f.write(json.dumps(rec) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"\nall {len(cells) * len(pods)} cells ran OK on the meta device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
