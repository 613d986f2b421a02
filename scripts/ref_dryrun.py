#!/usr/bin/env python3
"""Run the JAX package's multi-pod dry-run (``repro.launch.dryrun``) under
JAX 0.9 and later, on the CPU.

Since JAX 0.9, ``jax.make_mesh`` gives ``Explicit`` mesh axes by default,
and the reference's ``with_sharding_constraint`` calls refuse them ("can
only refer to Auto axes of the mesh"), so its own CLI stops at the first
step (ROADMAP C-29, on the reference's side). This wrapper changes nothing
in the package: it sets the reference's ``XLA_FLAGS`` (512 host devices,
the loop-invariant code motion pass off) before JAX is imported, makes
``jax.make_mesh`` default to ``Auto`` axes, and calls the reference's
``main`` with the arguments given:

    PYTHONPATH=src python scripts/ref_dryrun.py --arch zamba2-2.7b \\
        --shape prefill_32k --both-meshes --out experiments/dryrun_ref

Each combination compiles in a few seconds. The JSON files are the
reference's (``collectives`` parsed from the partitioned HLO text, each
collective in a loop body counted once); the port's own dry-run is
``python -m repro_torch.launch.dryrun``.
"""
from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("REPRO_EXTRA_XLA_FLAGS", "")
                           + " --xla_disable_hlo_passes="
                             "while-loop-invariant-code-motion"
                           + " --xla_force_host_platform_device_count=512").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

_make_mesh = jax.make_mesh


def _auto_mesh(axis_shapes, axis_names, *args, **kwargs):
    kwargs.setdefault("axis_types", (AxisType.Auto,) * len(axis_names))
    return _make_mesh(axis_shapes, axis_names, *args, **kwargs)


jax.make_mesh = _auto_mesh

from repro.launch import dryrun  # noqa: E402

if __name__ == "__main__":
    sys.argv[0] = "repro.launch.dryrun"
    dryrun.main()
