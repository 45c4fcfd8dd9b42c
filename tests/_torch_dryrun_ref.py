"""The reference's collectives on a (2, 4) mesh of 8 host devices.

Run as a script, in a process of its own: it sets ``XLA_FLAGS`` to 8
host devices before JAX starts.  It never imports
``repro.launch.dryrun`` (which forces 512).  Prints one JSON object:
the name of each lowered program -> ``parse_collective_bytes`` of its
compiled HLO.  Names: ``block`` (x [B, D] over "data" times w1 [D, F]
over "model" (columns), times w2 [F, D] over "model" (rows), the result
over "data"), and any ``arch:shape`` given on the command line, at 1
layer for an LM."""
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.roofline import parse_collective_bytes  # noqa: E402

#: the block's shapes, shared with the port's test
B, D, F = 64, 256, 512


def block(mesh):
    def fn(x, w1, w2):
        return (x @ w1) @ w2
    sh = [NamedSharding(mesh, P("data", None)),
          NamedSharding(mesh, P(None, "model")),
          NamedSharding(mesh, P("model", None))]
    args = [jax.ShapeDtypeStruct((B, D), jnp.float32),
            jax.ShapeDtypeStruct((D, F), jnp.float32),
            jax.ShapeDtypeStruct((F, D), jnp.float32)]
    with mesh:
        return jax.jit(fn, in_shardings=sh,
                       out_shardings=NamedSharding(mesh, P("data", None))
                       ).lower(*args).compile()


def cell(mesh, name):
    arch, shape = name.split(":")
    a = get_arch(arch)
    c = a.cell(shape, cfg_overrides={"n_layers": 1}) \
        if a.family == "lm" else a.cell(shape)
    return c.lower(mesh).compile()


def main(names):
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {"block": parse_collective_bytes(block(mesh).as_text())}
    for name in names:
        out[name] = parse_collective_bytes(cell(mesh, name).as_text())
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
