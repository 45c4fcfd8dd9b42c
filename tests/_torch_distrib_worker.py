"""One rank of the 4-rank gloo check in ``test_torch_distrib.py``.

    python _torch_distrib_worker.py RANK PORT CKPT_DIR OUT_DIR

Builds a (4,) and a (2, 2) ``DeviceMesh`` over a gloo group on
``tcp://localhost:PORT``, then writes ``OUT_DIR/rank<RANK>.pt``:

* ``placements``: each tiny-LM parameter distributed on the (2, 2) mesh
  by the rules, its local shard, its mesh coordinate and placements;
* ``activation``: a replicated [8, 4, 6] activation after ``shard_act``
  with ("batch", "seq", None) inside ``activation_sharding``, and
  whether a plain tensor passed through unchanged;
* ``restored``: the tiny LM's parameters saved from DTensors on the
  (4,) mesh (rank 0's directory), restored onto the (2, 2) mesh by
  ``restore_checkpoint(shardings=...)``: each leaf's local shard.
"""
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor

from repro_torch.configs import get_arch
from repro_torch.distrib.checkpoint import (restore_checkpoint,
                                            save_checkpoint)
from repro_torch.distrib.shardings import ShardingRules, placements_for
from repro_torch.models import lm
from repro_torch.models.common import (_leaves, _unflatten,
                                       activation_sharding, shard_act)


def main(rank: int, port: int, ckpt_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        run(rank, ckpt_dir, out_dir)
    finally:
        dist.destroy_process_group()


def run(rank: int, ckpt_dir: str, out_dir: str) -> None:
    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = ShardingRules()
    cfg = get_arch("smollm-360m").smoke()[0]
    specs = lm.param_specs(cfg)
    params, _ = lm.load_params(cfg, seed=3, device="cpu")   # every rank
    params["embed"] = params["embed"].to(torch.bfloat16)    # a bf16 leaf
    out = {"coord": mesh22.get_coordinate()}

    out["placements"] = {}
    for path, spec in _leaves(specs):
        pl = placements_for(rules.spec_of(spec, mesh22), mesh22)
        full = dict(_leaves(params))[path]
        dt = distribute_tensor(full, mesh22, pl, src_data_rank=None)
        assert torch.equal(dt.full_tensor(), full), path
        out["placements"][path] = (tuple(str(p) for p in dt.placements),
                                   dt.to_local().clone())

    x = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    xd = distribute_tensor(x, mesh22, (Replicate(), Replicate()))
    plain = torch.ones(3)
    with activation_sharding(mesh22, rules.spec_for):
        y = shard_act(xd, ("batch", "seq", None))
        out["plain_passes"] = shard_act(plain, ("batch",)) is plain
    out["activation"] = (tuple(str(p) for p in y.placements),
                         y.to_local().clone())
    out["outside_passes"] = shard_act(xd, ("batch", "seq", None)) is xd

    # save from the (4,) mesh: every rank joins full_tensor()'s gathers
    state = _unflatten(
        (path, distribute_tensor(
            t, mesh4, placements_for(
                rules.spec_of(dict(_leaves(specs))[path], mesh4), mesh4),
            src_data_rank=None))
        for path, t in _leaves(params))
    save_checkpoint(f"{ckpt_dir}/rank{rank}", 5, state)
    dist.barrier()
    shardings = _unflatten(
        (path, (mesh22, placements_for(rules.spec_of(s, mesh22), mesh22)))
        for path, s in _leaves(specs))
    like = _unflatten((path, t) for path, t in _leaves(params))
    restored, step = restore_checkpoint(f"{ckpt_dir}/rank0", like,
                                        shardings=shardings)
    assert step == 5
    out["restored"] = {path: (tuple(str(p) for p in t.placements),
                              str(t.dtype), t.to_local().clone())
                       for path, t in _leaves(restored)}
    torch.save(out, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
