"""The port's `spmd` backend on `torch.distributed` (gloo, on the CPU).

One group per shard count P in {2, 4}: P ranks, spawned with
`torch.multiprocessing`, meet through a `file://` rendezvous under the
test's tmp_path (no TCP port, so parallel test workers cannot collide), each
with a 60 s collective timeout and one intra-op thread. Every rank prunes
the three cases of tests/test_torch_sharded.py with `mesh=group` and
enumerates the result through both sharded joins and streaming; the parent
holds every rank's result to the JAX package's single-device prune and
enumeration, and to the port's `sim` backend at the same P for the
counters. The ranks import only the port (the module imports neither JAX
nor the JAX package at the top; the parent's reference imports are inside
the tests), and check that. A rank that does not finish within the test's
deadline is terminated and fails the test.
"""
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_spawn import spawn as _spawn  # noqa: E402

CASES = [
    ("cyclic", [8, 7, 7], [(0, 1), (1, 2), (2, 0)], dict(guarantee_precision=False)),
    ("path", [3, 4, 5, 3], [(0, 1), (1, 2), (2, 3)], dict(guarantee_precision=False)),
    ("tds", [4, 3, 5, 3], [(0, 1), (1, 2), (2, 3)], dict(guarantee_precision=True)),
]
COUNTERS = ("nlcc_waves", "nlcc_overlapped_waves", "nlcc_host_syncs",
            "nlcc_tokens", "tds_gather_bridge")


def _summary(res):
    return dict(
        traj=np.array([(p.active_vertices, p.active_edges, p.omega_bits)
                       for p in res.phases], dtype=np.int64).reshape(-1, 3),
        counters=np.array([[p.extra.get(k, 0) for k in COUNTERS]
                           for p in res.phases], dtype=np.int64).reshape(-1, len(COUNTERS)),
        lcc_iterations=res.stats["lcc_iterations"])


def _rank_main(rank, P, init, out):
    """One rank: runs in a spawned process that imports only the port."""
    import torch.distributed as dist
    from repro_torch.core.enumerate import (count_matches, enumerate_matches,
                                            stream_matches)
    from repro_torch.core.pipeline import prune
    from repro_torch.core.template import Template
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.partition import partition_graph
    from repro_torch.launch.mesh import make_shard_group

    torch.set_num_threads(1)
    group = make_shard_group(P, backend="gloo", init_method=init, rank=rank,
                             timeout_s=60)
    g = rmat_graph(9, edge_factor=6, seed=5)
    for name, labels, edges, kw in CASES:
        t = Template(labels, edges)
        res = prune(g, t, mesh=group, device="cpu", **kw)
        assert res.stats["backend"] == "spmd" and res.stats["sharded"]["P"] == P
        st = {}
        emb = enumerate_matches(res, stats=st)
        assert st["enumerate_join_engine"] == "rowsharded"
        rep = enumerate_matches(res, route="replicated")
        blocks = list(stream_matches(res, max_rows=64))
        streamed = (np.unique(np.concatenate(blocks), axis=0) if blocks
                    else np.zeros((0, t.n0), np.int32))
        np.savez(os.path.join(out, f"{name}_{rank}.npz"),
                 omega=res.omega, edge_mask=res.edge_mask,
                 vertex_mask=res.vertex_mask, emb=emb.embeddings,
                 emb_replicated=rep.embeddings, streamed=streamed,
                 count=count_matches(res).n_embeddings,
                 count_replicated=count_matches(res, route="replicated").n_embeddings,
                 **_summary(res))
    t = Template(*CASES[0][1:3])
    refused = []
    for other in (max(P // 2, 1), 2 * P):  # coarser and finer than the group
        try:
            prune(g, t, mesh=group, partition=partition_graph(g, other),
                  device="cpu")
        except ValueError as e:
            refused.append(str(e))
    assert len(refused) == 2 and all("shards" in m for m in refused), refused
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """The JAX package's single-device prune and enumeration per case."""
    from repro.core.enumerate import enumerate_matches as renumerate
    from repro.core.pipeline import prune as rprune
    from repro.core.template import Template as RT
    from repro.graph.generators import rmat_graph as rrmat

    rg = rrmat(9, edge_factor=6, seed=5)
    out = {}
    for name, labels, edges, kw in CASES:
        res = rprune(rg, RT(labels, edges), **kw)
        out[name] = dict(
            omega=np.asarray(res.omega), edge_mask=np.asarray(res.edge_mask),
            vertex_mask=np.asarray(res.vertex_mask),
            traj=np.array([(p.active_vertices, p.active_edges, p.omega_bits)
                           for p in res.phases]),
            emb=np.asarray(renumerate(res).embeddings))
    return out


@pytest.mark.parametrize("P", [2, 4])
def test_spmd_gloo_equals_the_reference(tmp_path, reference, P):
    from repro_torch.core.pipeline import prune
    from repro_torch.core.template import Template
    from repro_torch.graph.generators import rmat_graph

    init = f"file://{tmp_path / 'rendezvous'}"
    _spawn(_rank_main, P, (P, init, str(tmp_path)))
    g = rmat_graph(9, edge_factor=6, seed=5)
    for name, labels, edges, kw in CASES:
        ref = reference[name]
        sim = _summary(prune(g, Template(labels, edges), device="cpu",
                             partition=P, **kw))
        for rank in range(P):
            got = np.load(tmp_path / f"{name}_{rank}.npz")
            tag = f"{name} P={P} rank {rank}"
            for k in ("omega", "edge_mask", "vertex_mask", "traj"):
                np.testing.assert_array_equal(ref[k], got[k], err_msg=f"{tag} {k}")
            for k in ("emb", "emb_replicated", "streamed"):
                np.testing.assert_array_equal(ref["emb"], got[k], err_msg=f"{tag} {k}")
            assert int(got["count"]) == int(got["count_replicated"]) == len(ref["emb"])
            np.testing.assert_array_equal(sim["counters"], got["counters"], err_msg=tag)
            assert int(got["lcc_iterations"]) == sim["lcc_iterations"], tag


def _lone_rank(rank, init):
    """Rank 0 of a group of two whose other rank never comes."""
    from repro_torch.launch.mesh import make_shard_group

    make_shard_group(2, backend="gloo", init_method=init, rank=rank,
                     timeout_s=3)


def test_a_rank_that_waits_fails_within_its_deadline(tmp_path):
    """A group whose peer never arrives fails on its own timeout, well
    inside the test's deadline, instead of hanging the run."""
    t0 = time.monotonic()
    with pytest.raises(Exception):
        _spawn(_lone_rank, 1, (f"file://{tmp_path / 'rendezvous'}",),
               deadline_s=60)
    assert time.monotonic() - t0 < 60


def test_gloo_group_refuses_a_cuda_device(tmp_path):
    """A gloo group carries CPU tensors: prune on it with a CUDA device (the
    default) raises instead of copying through the host."""
    import torch.distributed as dist
    from repro_torch.core.engine import _group_device
    from repro_torch.launch.mesh import make_shard_group

    if dist.is_initialized():
        pytest.skip("a default process group exists in this process")
    group = make_shard_group(1, backend="gloo", rank=0,
                             init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        assert _group_device(group, "cpu").type == "cpu"
        with pytest.raises((ValueError, RuntimeError), match="gloo|CUDA"):
            _group_device(group, "cuda")
        with pytest.raises((ValueError, RuntimeError), match="gloo|CUDA"):
            _group_device(group, None)
    finally:
        dist.destroy_process_group()
