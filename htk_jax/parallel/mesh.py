"""Data-parallel training over a device mesh.

The one-program equivalent of HTK's parallel mode (SURVEY.md §2.6/§5.8):
HTK shards the corpus across N `HERest -p n` jobs that exchange binary
accumulator files; here the same algebra — accumulator addition is exact
and associative — runs as one SPMD program: utterance batches shard over
the mesh's data axis, every device scans its shard, and the Accumulators
pytree is `psum`'d across the devices. Serial and sharded training are bit-for-bit
reproducible up to f32 summation order (tests assert tight equality).

Multi-host extension: call jax.distributed.initialize() before building
the mesh; the same shard_map program then spans hosts with psums riding
the card interconnect within a host and the network between hosts.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..algo.fb import Accumulators, fb_batch, zero_accs
from ..algo.trainer import Trainer, UttData, make_batches, pad_batch
from ..utils.logmath import LZERO


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Multi-host bring-up (SURVEY §5.8).

    Initialises JAX's distributed runtime so make_mesh() spans every
    host's devices: accumulator psums then ride the card interconnect
    within a host and the network between hosts, exactly like `HERest -p
    N` jobs exchanging acc
    files across machines — but as one program.

    Arguments default to JAX's standard environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). Returns True when a
    multi-host runtime was (or already is) initialised; False on a
    plain single-host run with no coordinator configured — callers can
    treat this as "mesh stays host-local".
    """
    import os

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if jax.process_count() > 1:
        return True  # already initialised by the launcher
    if not coordinator:
        return False
    kw = {"coordinator_address": coordinator}
    np_ = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None \
        else os.environ.get("JAX_PROCESS_ID")
    if np_ is not None:
        kw["num_processes"] = int(np_)
    if pid is not None:
        kw["process_id"] = int(pid)
    jax.distributed.initialize(**kw)
    return True


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


class ShardedTrainer(Trainer):
    """Trainer whose batch step shards utterances across a mesh."""

    def __init__(self, comp, mesh: Mesh, axis: str = "data",
                 precision: str = "highest", prune=None):
        super().__init__(comp, precision=precision, prune=prune)
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.devices.size

    def _make_step_fn(self):
        axis = self.axis
        pruned = self.prune is not None

        def local(params, batch, beam):
            means, variances, gconsts, state_mix, state_logw, state_sw = params
            logps, accs = fb_batch(
                batch["feats"], batch["t_real"], batch["comp_state"],
                batch["q_mask"], batch["logA"], batch["a0"], batch["aE"],
                batch["tr_seg"], batch["entry_seg"], batch["exit_seg"],
                means=means, variances=variances, gconsts=gconsts,
                state_mix=state_mix, state_logw=state_logw,
                state_sw=state_sw, slot_blocks=tuple(self.comp.slot_blocks)
                or None,
                n_states=self.comp.n_states, tr_flat=self.tr_flat,
                precision=self.precision,
                beam=beam if pruned else None,
            )
            # exact accumulator exchange: the psum IS HERest's acc-file
            # combine step, riding the interconnect, not the filesystem
            accs = jax.lax.psum(accs, axis)
            return logps, accs

        sharded = jax.jit(jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(), P(self.axis), P()),
            out_specs=(P(self.axis), P()),
        ))

        def step(params, batch, beam=None):
            b = jnp.float32(1e30 if beam is None else beam)
            return sharded(params, batch, b)

        return step

    def _run_pass(self, utts, batch_size, step, params, total, beam):
        """One sharded pass; batch_size is per device (padded rows
        contribute zero accumulators)."""
        c = self.comp
        gbs = batch_size * self.n_dev
        pending = []
        for batch in make_batches(utts, gbs):
            bp = math.ceil(len(batch) / self.n_dev) * self.n_dev
            arrs = pad_batch(batch, c.n_states, pad_to=bp)
            jb = {k: jnp.asarray(v) for k, v in arrs.items()}
            logps, accs = step(params, jb, beam)
            total = jax.tree.map(lambda a, b: a + b, total, accs)
            pending.append((batch, logps))
        flat = []
        for batch, logps in pending:
            lp = np.asarray(logps)
            flat.extend(zip(batch, lp[: len(batch)]))
        return total, flat
