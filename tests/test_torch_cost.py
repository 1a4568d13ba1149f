"""The kernels' work formulas (`kernels/cost.py`), the roofline
(`launch/roofline.py`), the cost counter (`launch/op_cost.py`) and the dry
run (`launch/dryrun.py`, `launch/perf_iter.py`), on the CPU.

`kernels/cost.py` reproduces the bounds PERF.md records for the kernels'
timed shapes on the H100; the counter counts a product's 2mkn FLOPs, no
bytes for a view, a kernel wrapper's call by its formula and none of its
plain version's ops, and the bytes of a sharded exchange; the dry run
writes a record of the documented schema per cell. No JAX here: the
reference's cost tools read XLA's HLO, which the port has not."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import sim_prims  # noqa: E402
from repro_torch.kernels import cost, ops, ref  # noqa: E402
from repro_torch.launch import dryrun, perf_iter, roofline  # noqa: E402
from repro_torch.launch.op_cost import OpCounter, counted_prims  # noqa: E402
from torch_train_util import few_torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("name,cost_,peak,bound_ms", [
    ("flash_attention [1,12/2,32768,128] bf16 causal",
     cost.attention_cost(1, 12, 2, 32768, 128, 2), roofline.PEAK_FLOPS, 3.3353),
    ("flash_attention MLA [1,16/16,32768,192/128] bf16 causal",
     cost.attention_cost(1, 16, 16, 32768, 192, 2, dv=128), roofline.PEAK_FLOPS, 5.5589),
    ("segment_agg [15360,10,602] f32",
     cost.segment_agg_cost(15360, 10, 602, 4), roofline.PEAK_FLOPS_F32, 0.1546),
    ("embedding_bag retrieval_cand: 1,000,000 bags of 1 over [1000002, 64] bf16",
     cost.embedding_bag_cost(1_000_000, 1, 64, 2, 1_000_000), roofline.PEAK_FLOPS_F32,
     0.0788),
])
def test_cost_formulas_give_the_recorded_bounds(name, cost_, peak, bound_ms):
    ms, _ = cost.bound(cost_, peak)
    assert round(ms, 4) == bound_ms, name


def test_bound_takes_the_larger_term_and_the_attention_pairs():
    assert cost.bound((3.35e9, 0)) == pytest.approx((1.0, "bytes"))
    assert cost.bound((0, 67e9)) == pytest.approx((1.0, "operations"))
    assert cost.attention_pairs(4, causal=True, window=None) == 10
    assert cost.attention_pairs(4, causal=False, window=None) == 16
    assert cost.attention_pairs(5, causal=True, window=2) == 9


def test_roofline_terms():
    r = roofline.Roofline(arch="a", shape="s", mesh="one_card", chips=1,
                          flops_tc_per_device=989e12, flops_f32_per_device=67e12,
                          bytes_per_device=3.35e12, collective_bytes_per_device=450e9,
                          model_flops=989e12)
    assert r.compute_s == pytest.approx(2.0)
    assert r.memory_s == pytest.approx(1.0) and r.collective_s == pytest.approx(1.0)
    assert r.bottleneck == "compute" and r.bound_s == pytest.approx(2.0)
    assert r.roofline_fraction == pytest.approx(0.5)
    assert set(r.to_dict()) >= {"compute_s", "memory_s", "collective_s", "bottleneck"}


def test_a_product_counts_2mkn_and_a_view_no_bytes():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with OpCounter() as c:
        a @ b
    assert c.flops_f32 == 2 * 8 * 16 * 4 and c.flops_tc == 0
    assert c.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    with OpCounter() as c:
        a.view(16, 8).t()[0:3]
        a[2:5].reshape(-1)
        a.expand(2, 8, 16)
    assert c.bytes == 0 and c.flops_f32 == 0 and c.n_ops > 0
    with OpCounter() as c:  # a reshape that must copy moves its bytes
        a.t().reshape(-1)
    assert c.bytes == 2 * 8 * 16 * 4
    with OpCounter() as c:
        a.to(torch.bfloat16) @ b.to(torch.bfloat16)
    assert c.flops_tc == 2 * 8 * 16 * 4 and c.flops_f32 == 0


def test_kernel_wrappers_count_their_formula_and_not_their_plain_version():
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((7, 5, 9), dtype=np.float32))
    mask = torch.from_numpy(rng.random((7, 5)) < 0.7)
    with OpCounter() as c:
        out = ops.segment_agg(feats, mask)
    assert torch.equal(out, ref.segment_agg_ref(feats, mask))
    want = cost.segment_agg_cost(7, 5, 9, 4)
    assert c.kernels == {"segment_agg": {"calls": 1, "bytes": want[0],
                                         "operations": want[1]}}
    assert (c.bytes, c.flops_f32, c.n_ops) == (want[0], want[1], 0)

    q = torch.randn(2, 4, 40, 64, dtype=torch.bfloat16)
    k = torch.randn(2, 2, 40, 64, dtype=torch.bfloat16)
    with OpCounter() as c:
        ops.attention(q, k, k, causal=True, window=16)
    want = cost.attention_cost(2, 4, 2, 40, 64, 2, causal=True, window=16)
    assert c.kernels["flash_attention"] == {"calls": 1, "bytes": want[0],
                                            "operations": want[1]}
    assert c.flops_tc == want[1] and c.n_ops == 0

    table = torch.randn(50, 8, dtype=torch.bfloat16)
    ids = torch.randint(0, 50, (6, 3), dtype=torch.int32)
    with OpCounter() as c:
        ops.embedding_bag(table, ids, torch.ones(6, 3))
    want = cost.embedding_bag_cost(6, 3, 8, 2, 18)
    assert c.kernels["embedding_bag"] == {"calls": 1, "bytes": want[0],
                                          "operations": want[1]}


def test_a_kernels_backward_is_counted_op_by_op():
    """The plain backward of segment_agg runs outside the wrapper: its ops
    count, the forward's do not."""
    feats = torch.randn(4, 3, 5, requires_grad=True)
    mask = torch.ones(4, 3, dtype=torch.bool)
    with OpCounter() as c:
        ops.segment_agg(feats, mask).sum().backward()
    assert c.kernels["segment_agg"]["calls"] == 1
    assert c.n_ops > 0 and c.bytes > c.kernels["segment_agg"]["bytes"]


def test_meta_tensors_take_no_kernel_and_no_plain_version():
    q = torch.empty(1, 4, 32768, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 2, 32768, 128, dtype=torch.bfloat16, device="meta")
    with OpCounter() as c:
        out = ops.attention(q, k, k)
    assert out.is_meta and out.shape == q.shape and c.n_ops == 0
    assert c.flops_tc == cost.attention_cost(1, 4, 2, 32768, 128, 2)[1]
    x = torch.empty(10, 4, 6, device="meta")
    assert ops.segment_agg(x, torch.empty(10, 4, dtype=torch.bool,
                                          device="meta")).shape == (10, 4, 6)


def test_the_attention_backward_counts_its_formula_and_none_of_its_ops():
    """The plain backward of `ops.attention` is counted by
    `attention_backward_cost` (its gradients those of
    `ref.attention_backward`), and on meta it computes nothing."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 33, 64, generator=g, requires_grad=True)
    k = torch.randn(2, 2, 33, 64, generator=g, requires_grad=True)
    v = torch.randn(2, 2, 33, 64, generator=g, requires_grad=True)
    do = torch.randn(2, 4, 33, 64, generator=g)
    for causal, window in ((True, None), (False, None), (True, 7)):
        out = ops.attention(q, k, v, causal=causal, window=window)
        with OpCounter() as c:
            got = torch.autograd.grad(out, (q, k, v), do)
        want = cost.attention_backward_cost(2, 4, 2, 33, 64, 4, causal, window)
        assert c.kernels == {"attention_backward": {"calls": 1, "bytes": want[0],
                                                    "operations": want[1]}}
        assert (c.flops_f32, c.flops_tc, c.n_ops) == (want[1], 0, 0)
        plain = ref.attention_backward(q.detach(), k.detach(), v.detach(), do,
                                       causal=causal, window=window)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    meta = [torch.empty(t.shape, device="meta", requires_grad=True) for t in (q, k, v)]
    out, do_meta = ops.attention(*meta), torch.empty(do.shape, device="meta")
    with OpCounter() as c:
        got = torch.autograd.grad(out, meta, do_meta)
    assert [t.shape for t in got] == [t.shape for t in meta] and c.n_ops == 0
    assert c.kernels["attention_backward"]["operations"] == cost.attention_backward_cost(
        2, 4, 2, 33, 64, 4)[1]


def test_a_sim_exchange_counts_its_bytes_per_device_both_ways():
    P, B, F = 2, 5, 3
    prims = counted_prims(sim_prims(P, "cpu"), P)
    x = torch.randn(P, P, B, F, requires_grad=True)
    with OpCounter() as c:
        out = prims.exchange(x)
    assert torch.equal(out, x.transpose(0, 1))
    assert c.collectives["all-to-all"] == P * B * F * 4
    with OpCounter() as c:
        prims.exchange(x).sum().backward()
        prims.psum(torch.ones(P))
        prims.replicate(torch.ones(7, requires_grad=True)).sum().backward()
    assert c.collectives["all-to-all"] == 2 * P * B * F * 4
    # the psum's operand per shard, and the parameter gradient's reduction
    assert c.collectives["all-reduce"] == 4 + 7 * 4
    one = sim_prims(1, "cpu")
    assert counted_prims(one, 1) is one  # one shard moves nothing over a link


RECORD_KEYS = {"arch", "shape", "mesh", "chips", "status", "step_kind", "trace_s",
               "memory", "counted", "model_flops", "roofline", "specs", "note"}


def test_dry_run_writes_a_record_per_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "gin-tu", "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    printed = capsys.readouterr().out
    assert printed.count("[ok] one_card gin-tu x") == 4
    assert "[skipped] one_card qwen2-1.5b x long_500k: full quadratic attention" in printed
    recs = {p.name: json.loads(p.read_text()) for p in (tmp_path / "one_card").iterdir()}
    assert len(recs) == 5
    skipped = recs["qwen2-1.5b__long_500k.json"]
    assert skipped["status"] == "skipped" and skipped["reason"]
    for name, rec in recs.items():
        if rec["status"] == "skipped":
            continue
        assert set(rec) == RECORD_KEYS, name
        assert rec["memory"]["temp_bytes"] is None and rec["memory"]["fits_80gib"]
        assert rec["counted"]["flops"] > 0 and rec["counted"]["bytes"] > 0
        r = rec["roofline"]
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert r["memory_s"] == pytest.approx(rec["counted"]["bytes"] / roofline.HBM_BW)


def test_perf_iter_reaches_the_distributed_cell(tmp_path, capsys):
    rec = perf_iter.main(["--arch", "pna", "--shape", "full_graph_sm", "--chips", "2",
                          "--set", "distributed=true", "--set", "message_dtype=bfloat16",
                          "--tag", "bf16", "--out", str(tmp_path),
                          "--baseline", str(tmp_path / "none")])
    assert rec["overrides"] == {"distributed": True, "message_dtype": "bfloat16"}
    assert rec["mesh"] == "sim_2" and "sim backend" in rec["note"]
    coll = rec["counted"]["collectives"]
    # one exchange a layer of pna's 4, and its transpose in the backward of
    # each but the first (the input features take no gradient)
    assert coll["n_all-to-all"] == 4 + 3 and coll["all-to-all"] > 0
    assert rec["specs"][1]["x"] == ("shards", None, None)
    assert (tmp_path / "pna__full_graph_sm__bf16.json").exists()
    assert "bf16: compute=" in capsys.readouterr().out
