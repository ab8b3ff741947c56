"""The hub's owner sums in a fixed order (``ops/segment.py::owner_offsets``,
``hub_owner_sum``), on the CPU.

A hub vertex's CSR row is cut into virtual rows, whose partial sums go
into the owner's row.  The port sums each owner's run of virtual rows with
``torch.segment_reduce`` over static offsets, in row order, so that a run
on the card gives the same bits every time; the JAX package sums them with
``jax.ops.segment_sum``.
Held here:

* the sum equals an in-order loop of f32 adds, bit for bit, for every
  owner of the sync layout's and of each vertex shard's hub;
* a bf16 or f16 destination gets that f32 sum rounded once;
* the sum against ``jax.ops.segment_sum`` over the JAX layout's hub rows
  (the padding rows' partials 0, as the edge kernel writes them), within
  rtol 1e-6, atol 1e-7: both add the same f32 terms, in orders that may
  differ;
* the run offsets refuse owners that are not one run each;
* the sync and vertex layouts this repo's tests train on have a hub, so
  that their iterations against the JAX package run this sum.
"""

import numpy as np
import pytest
import torch

from force2vec_tpu_torch.graphs import SyncLayout, synth_powerlaw_graph
from force2vec_tpu_torch.graphs.partition import VertexShardLayout
from force2vec_tpu_torch.ops.segment import hub_owner_sum, owner_offsets

GRAPH = dict(n=300, avg_deg=6, seed=3)
LAYOUT = dict(min_width=4, hub_width=16)
DIM = 12


def _graph():
    return synth_powerlaw_graph(**GRAPH)


def _sync_hub():
    lay = SyncLayout.build(_graph(), **LAYOUT)
    hub = next(b for b in lay.buckets if b.owners is not None)
    return lay, hub


def _partials(count, deg, seed):
    """Random f32 partial rows, 0 on the padding rows (deg 0), as the
    edge kernel leaves them."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((count, DIM)).astype(np.float32)
    src[deg == 0] = 0.0
    return src


def _loop_sum(src, owners, deg, n_owners):
    """Each owner's real virtual rows added one by one in f32, in row
    order, from 0."""
    out = np.zeros((n_owners, src.shape[1]), dtype=np.float32)
    for v in range(src.shape[0]):
        if deg[v] > 0:
            out[owners[v]] = out[owners[v]] + src[v]
    return out


def _hubs():
    """(what, owner offsets, deg, owner rows) of the sync layout's hub and
    of each P = 4 vertex shard's."""
    lay, hub = _sync_hub()
    cases = [("sync", hub.owners - hub.start, hub.deg, lay.n - hub.start)]
    vl = VertexShardLayout.build(_graph(), 4, **LAYOUT)
    vh = vl.buckets[-1]
    assert vh.owners is not None
    for p in range(4):
        cases.append((f"vertex shard {p}", vh.owners[p], vh.deg[p],
                      vl.n_loc - vh.start_local))
    return cases


@pytest.mark.parametrize("case", range(5))
def test_hub_owner_sum_is_an_in_order_f32_loop(case):
    what, owners, deg, n_owners = _hubs()[case]
    src = _partials(owners.shape[0], deg, case)
    offsets = owner_offsets(owners, deg, n_owners)
    nv = int(offsets[-1])
    assert nv == np.count_nonzero(deg > 0), what
    assert (np.diff(offsets) > 0).any(), what
    dst = torch.full((n_owners, DIM), float("nan"))
    got = hub_owner_sum(dst, torch.from_numpy(src[:nv]),
                        torch.from_numpy(offsets))
    assert got is dst
    np.testing.assert_array_equal(got.numpy(),
                                  _loop_sum(src, owners, deg, n_owners))


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("case", ("sync", "long runs"))
def test_a_two_byte_destination_takes_the_f32_sum_rounded_once(dtype, case):
    if case == "sync":
        _, owners, deg, n_owners = _hubs()[0]
    else:  # an owner of 40 virtual rows and one of 30: many roundings
        owners = np.repeat(np.arange(2, dtype=np.int32), (40, 30))
        deg, n_owners = np.ones(70, np.int32), 3
    src = torch.from_numpy(_partials(owners.shape[0], deg, 9)).to(dtype)
    offsets = owner_offsets(owners, deg, n_owners)
    nv = int(offsets[-1])
    got = hub_owner_sum(torch.zeros((n_owners, DIM), dtype=dtype), src[:nv],
                        torch.from_numpy(offsets))
    want = _loop_sum(src.float().numpy(), owners, deg, n_owners)
    assert got.dtype == dtype
    assert torch.equal(got, torch.from_numpy(want).to(dtype))
    if case == "long runs":  # each add rounded to the 2-byte type differs
        per_add = torch.zeros((n_owners, DIM), dtype=dtype)
        for v in range(nv):
            per_add[owners[v]] = per_add[owners[v]] + src[v]
        assert not torch.equal(per_add, got)


def test_hub_owner_sum_matches_jax_segment_sum():
    import jax
    import jax.numpy as jnp

    from force2vec_tpu.graphs.csr import Graph as JaxGraph
    from force2vec_tpu.graphs.csr import SyncLayout as JaxSyncLayout

    g = _graph()
    jl = JaxSyncLayout.build(JaxGraph(g.n, g.rowptr, g.colids), **LAYOUT)
    jh = next(b for b in jl.buckets if b.owners is not None)
    lay, hub = _sync_hub()
    np.testing.assert_array_equal(hub.owners, jh.owners)
    n_owners = lay.n - hub.start
    src = _partials(hub.count, hub.deg, 4)
    want = jax.ops.segment_sum(jnp.asarray(src),
                               jnp.asarray(jh.owners - jh.start),
                               num_segments=n_owners)
    offsets = owner_offsets(hub.owners - hub.start, hub.deg, n_owners)
    got = hub_owner_sum(torch.zeros((n_owners, DIM)),
                        torch.from_numpy(src[: int(offsets[-1])]),
                        torch.from_numpy(offsets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_owner_offsets_refuse_owners_out_of_order():
    owners = np.array([0, 0, 1, 1, 2, 0], dtype=np.int32)
    deg = np.array([3, 2, 3, 1, 2, 0], dtype=np.int32)
    np.testing.assert_array_equal(owner_offsets(owners, deg, 4),
                                  [0, 2, 4, 5, 5])
    with pytest.raises(ValueError, match="one run"):
        owner_offsets(np.array([0, 1, 0, 2]), np.array([1, 1, 1, 0]), 3)
    # a real row after a padding row
    with pytest.raises(ValueError, match="one run"):
        owner_offsets(np.array([0, 0, 1]), np.array([1, 0, 1]), 2)
    with pytest.raises(ValueError, match="one run"):
        owner_offsets(np.array([0, 3]), np.array([1, 1]), 3)


def test_the_parity_layouts_have_a_hub():
    """This graph at hub width 16, which the sharded and vertex tests
    train on, cuts rows into virtual rows in the sync layout and in every
    vertex shard, so their iterations against the JAX package run the
    ordered sum."""
    from force2vec_tpu_torch.train.sync import SyncForce2Vec
    from force2vec_tpu_torch.train.trainer import TrainConfig

    fv = SyncForce2Vec(_graph(), TrainConfig(dim=DIM), device="cpu",
                       **LAYOUT)
    assert fv._hub is not None and fv._hub.n_virtual > 0
    assert int(fv._hub.owner_off[-1]) == fv._hub.n_virtual
    from force2vec_tpu_torch.dist.vertex_sharded import ShardTables

    t = ShardTables.build(VertexShardLayout.build(_graph(), 4, **LAYOUT), 2,
                          "cpu")
    assert t.hub_off is not None and int(t.hub_off[-1]) == t.hub_virtual > 0
