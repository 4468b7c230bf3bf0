"""Multi-chip fragment search over a `jax.sharding.Mesh`.

The reference scales by handing (target, fragment) work items to OpenMP
threads or MPI workers (reference tntblast_local.cpp:318-324,
tntblast_master.cpp:429-511 — "database segmentation").  Here the
equivalent is SPMD data parallelism over the fragment axis:

  * database fragments are the sharded batch axis (PartitionSpec("data")),
  * the oligo panel, thermodynamic score tables and thresholds are
    replicated (PartitionSpec()),
  * each device runs the pooled panel step (parallel/device_search.py) on
    its local fragment shard — seeding, compaction, and the chunked
    screening DP with empty-chunk skip,
  * the packed resolve payloads stay sharded: the coordinator host reads
    each device's shard directly, in place of the reference's chunked
    `SIGNATURE_RESULTS` MPI gather (tntblast_master.cpp:760-849).  No
    collective runs between the devices.

Host-side exact re-scoring / pairing stays on the coordinator host exactly
like the reference master's reduce phase; the packed fixed-layout
candidate buffers are the fixed-shape analogue of the hybrid_sig X-macro
records (hybrid_sig.h:121-164).
"""

import functools

import numpy as np

from tntblast_tpu.jaxconf import configure as _jaxconf
_jaxconf()

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tntblast_tpu import constants as C
from tntblast_tpu.parallel.device_search import (
    _PANEL_TABLES, DevicePanel, PanelConfig, panel_step_core)


def make_mesh(devices=None, axis_name="data"):
    """1-D data-parallel mesh over all (or the given) devices.  Cached:
    a fresh Mesh object per search would defeat the jit cache of the
    sharded step (retrace on every run)."""
    if devices is None:
        devices = jax.devices()
    return _mesh_cached(tuple(devices), axis_name)


@functools.lru_cache(maxsize=None)
def _mesh_cached(devices, axis_name):
    return Mesh(np.asarray(devices), (axis_name,))


def build_sharded_step(mesh, cfg: PanelConfig, n_local, slot_meta,
                       eval_const, s_max, k_max, eval_on, tab_digest,
                       axis_name="data", full=False):
    return _sharded_step_cached(mesh, cfg.key(), n_local, slot_meta,
                                eval_const, s_max, k_max, eval_on,
                                tab_digest, axis_name, full)


@functools.lru_cache(maxsize=None)
def _sharded_step_cached(mesh, cfg_key, n_local, slot_meta,
                         eval_const, s_max, k_max, eval_on, tab_digest,
                         axis_name, full):
    """jit-compiled SPMD step, shared across MeshPanel instances (jax
    Mesh is hashable): (n_dev * n_local, tile_len) fragments sharded
    over the mesh; each device runs the pooled panel step on its local
    shard, and every output stays sharded with a leading device axis, so
    the coordinator host resolves one buffer per device."""
    cfg = PanelConfig(word_len=cfg_key[0], num_os=cfg_key[1],
                      max_words=cfg_key[2], wq_max=cfg_key[3],
                      tile_len=cfg_key[4], cap=cfg_key[5],
                      num_cond=cfg_key[6], kcap=cfg_key[7])
    step = functools.partial(
        panel_step_core,
        slot_meta=slot_meta, eval_const=eval_const,
        word_len=cfg.word_len, num_os=cfg.num_os,
        max_words=cfg.max_words, wq_max=cfg.wq_max, tile_len=cfg.tile_len,
        cap=cfg.cap, kcap=cfg.kcap, num_cond=cfg.num_cond,
        n_frags=n_local, s_max=s_max, k_max=k_max,
        eval_on=eval_on, full=full)
    tabs = _PANEL_TABLES[tab_digest]

    def local_shard(fp, frag_lens, rs, re_, ep, ec, iov):
        # panel tables are folded as compile-time constants (replicated
        # by construction on every device)
        out = step(fp, frag_lens, rs, re_, ep, ec, iov, *tabs)
        # leading device axis; outputs STAY SHARDED on the mesh (no
        # all_gather): only the coordinator host reads them, one shard
        # per device — the host-side resolve reads each device's shard
        return tuple(x[None] for x in out)

    n_out = 7
    sharded = jax.shard_map(
        local_shard, mesh=mesh,
        in_specs=tuple([P(axis_name)] * 7),
        out_specs=tuple(P(axis_name) for _ in range(n_out)),
        # the DP scan's carry-init constants are unvarying on the data
        # axis by construction; skip the varying-manual-axes check
        check_vma=False)
    jitted = jax.jit(sharded)

    def call(fp, frag_lens, rs, re_, ep, ec, iov, *_legacy_table_args):
        return jitted(fp, frag_lens, rs, re_, ep, ec, iov)

    return call


class MeshPanel(DevicePanel):
    """DevicePanel that fans a batch of fragments out across a device mesh.

    The panel (oligo words/tables/thresholds) is packed once and
    replicated; fragments shard across devices; resolves unpack one packed
    buffer per device and return per-fragment host dicts in submission
    order — the same contract as DevicePanel, batched.
    """

    def __init__(self, panel, config, dg_tables, thresholds,
                 eval_dg=None, thermo_tables=None, mesh=None,
                 axis_name="data"):
        super().__init__(panel, config, dg_tables, thresholds,
                         eval_dg=eval_dg, thermo_tables=thermo_tables)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis_name = axis_name
        self.n_dev = self.mesh.devices.size
        self._steps = {}      # n_local -> jitted sharded step
        self._data_sharding = NamedSharding(self.mesh, P(axis_name))
        self._repl_sharding = NamedSharding(self.mesh, P())
        self._args_d = None   # replicated panel args, device_put once

    def submit_fragments(self, frag_code_list, full=False):
        """Enqueue the sharded step for a batch of fragments (async);
        resolve with `resolve_fragments`.  Pads the batch to a multiple of
        the mesh size with empty fragments (inert: zero seeds)."""
        cfg = self.config
        n = len(frag_code_list)
        n_pad = -(-n // self.n_dev) * self.n_dev
        n_local = n_pad // self.n_dev
        padded = list(frag_code_list) + [
            np.zeros(0, np.uint8)] * (n_pad - n)
        payload = self._pack_host(padded)

        step = self._steps.get((n_local, full))
        if step is None:
            step = self._steps[(n_local, full)] = build_sharded_step(
                self.mesh, cfg, n_local, self.slot_meta, self.eval_const,
                self.s_max, self.k_max, self.eval_on, self._tab_digest,
                self.axis_name, full=full)
        payload_d = tuple(jax.device_put(a, self._data_sharding)
                          for a in payload)
        if self._args_d is None:
            self._args_d = tuple(jax.device_put(a, self._repl_sharding)
                                 for a in self.args)
        return (n, n_local), step(*payload_d, *self._args_d)

    def _per_device(self, pending, resolver):
        """Resolve each device's shard of the outputs, read straight from
        that device: indexing the global arrays instead (`x[d]`) would
        compile a program that moves the slice between devices."""
        (n, n_local), out = pending
        shards = [sorted(x.addressable_shards, key=lambda s: s.index[0].start)
                  for x in out]
        results = []
        for d in range(self.n_dev):
            block = tuple(np.asarray(s[d].data)[0] for s in shards)
            results.extend(resolver(n_local, block))
            if len(results) >= n:
                break
        return results[:n]

    def resolve_fragments(self, pending):
        return self._per_device(
            pending,
            lambda nl, block: DevicePanel.resolve_fragments(
                self, (nl, block)))

    def resolve_fragments_full(self, pending):
        return self._per_device(
            pending,
            lambda nl, block: DevicePanel.resolve_fragments_full(
                self, (nl, block)))

    def run_fragments(self, frag_code_list):
        return self.resolve_fragments_full(
            self.submit_fragments(frag_code_list, full=True))
