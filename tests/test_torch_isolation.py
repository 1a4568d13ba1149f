"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and it never falls back to the CPU on its own."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")

# Runs in a fresh interpreter: a tiny CPU prune through the whole main path
# (sharded on the sim backend too, with the edge-prune pass, the device join, streaming, a planned prune, a
# tune and the quickstart), a batched prune, graph-query serving (engine and
# CLI), a resilient prune (a checkpoint, an elastic restart onto one shard,
# a triggered rebalance), a sharded batch and sharded serving (engine and
# CLI), an incremental and an exploratory search and their launcher, a tiny
# sampled GNN forward, a tiny greedy generation by each of the five LM
# archs (MLA, MoE and the sliding-window ring among them), a deepseek-v3
# loss with MTP and the router aux loss, the serving CLI on an MLA arch, a
# bf16 checkpoint round trip, a retrieval, a few
# train steps through the training launchers and the train step (optim,
# train, the negatives' generator; a donated MoE step and the MoE launcher),
# PNA's mean and std, the sharded PNA loss on the sim
# backend, the sharding rules, a dry run of one cell (and of a cut one),
# the oracle, counts, generators, configs and recsys scorer helpers, and
# perf_iter of the
# distributed cell on the meta device under the cost counter (cells,
# abstract, op_cost, roofline, kernels.cost), the LM train step on a (1, 1)
# mesh of one gloo rank with its checkpoint saved, restored and resumed by
# the trainer (launch.mesh, sharding's placing and gathering), then checks that nothing of JAX or the JAX package was loaded, and that the
# default device is CUDA (which raises where there is none).
SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.graph import generators as gen
    from repro_torch.core.template import Template
    from repro_torch.core.pipeline import prune
    from repro_torch.core.enumerate import count_matches

    g = gen.cycle_graph(4, [0, 1, 2, 3])
    t = Template([0, 1, 2, 3], [(0, 1), (1, 2), (2, 3), (3, 0)])
    res = prune(g, t, device="cpu")
    assert count_matches(res).n_embeddings == 1
    sharded = prune(g, t, partition=2, device="cpu")
    assert sharded.stats["backend"] == "sim"
    assert count_matches(sharded).n_embeddings == 1

    from repro_torch.core.enumerate import stream_matches
    from repro_torch.core.planner import plan_query
    from repro_torch.graph.stats import collect_graph_stats
    from repro_torch.kernels import registry
    from repro_torch.launch import quickstart
    ep = prune(g, t, device="cpu", nlcc_edge_prune=True)
    assert ep.stats["tds_skipped_via_frontier_edge_prune"]
    assert count_matches(ep, route="device").n_embeddings == 1
    assert sum(b.shape[0] for b in stream_matches(ep, route="device")) == 1
    plan = plan_query(t, collect_graph_stats(g), backend="cpu")
    assert prune(g, t, device="cpu", plan=plan).counts() == res.counts()
    pol = registry.tune(routes=[("prune.lcc", registry.BUCKET_ANY,
                                 {"packed": lambda: None})],
                        backend="cpu", repeat=1, persist=False)
    assert pol.route_for("prune.lcc", "cpu", (4, 8)) == "packed"
    registry.set_policy(None)
    assert quickstart.main(["--device", "cpu"]).n_embeddings >= 20

    from repro_torch.core.batch import prune_batch
    from repro_torch.core.exploratory import exploratory_search
    from repro_torch.core.incremental import IncrementalSession
    from repro_torch.launch import interactive_search
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import GraphQueryEngine, MODE_COUNT
    bres = prune_batch(g, [t, t], device="cpu")
    assert all(torch.equal(r.state.omega, res.state.omega)
               for r in bres.results)
    eng = GraphQueryEngine(g, device="cpu")
    eng.submit(t, mode=MODE_COUNT)
    assert eng.drain()[0].n_embeddings == 1
    assert IncrementalSession(g, t, device="cpu").search(t)[1].matched_vertices == 4
    assert exploratory_search(g, t, device="cpu").found_level == 0
    served = serve_cli.main(["--graph-queries", "4", "--graph-scale", "6",
                             "--device", "cpu"])
    assert [r.status for r in served] == ["ok"] * 4

    import tempfile
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import loadbalance, resilience
    with tempfile.TemporaryDirectory() as d:
        inj = resilience.FaultInjector([resilience.FaultSpec(
            kind=resilience.FAULT_SHARD_LOSS, phase=1)])
        cfg = resilience.ResilienceConfig(
            checkpoint_dir=d, injector=inj,
            elastic=resilience.ElasticConfig(restart_P=1))
        rr = prune(g, t, partition=2, device="cpu", resilience=cfg)
        assert rr.stats["resilience"]["restarts"][0]["to_P"] == 1
        assert torch.equal(rr.state.omega, res.state.omega)
        assert ckpt.latest_valid_step(d) is not None
    rb = prune(g, t, partition=2, device="cpu",
               resilience=resilience.ResilienceConfig(
                   elastic=resilience.ElasticConfig(imbalance_trigger=0.5)))
    assert torch.equal(rb.state.omega, res.state.omega)
    assert loadbalance.imbalance_stats(g, None, 2).P == 2
    sb = prune_batch(g, [t, t], partition=2, device="cpu")
    assert all(torch.equal(r.state.omega, res.state.omega)
               for r in sb.results)
    seng = GraphQueryEngine(g, partition=2, device="cpu")
    seng.submit(t, mode=MODE_COUNT)
    assert seng.drain()[0].n_embeddings == 1
    served = serve_cli.main(["--graph-queries", "4", "--graph-scale", "6",
                             "--device", "cpu", "--partition", "2"])
    assert [r.status for r in served] == ["ok"] * 4
    assert interactive_search.main(["--device", "cpu"])[1].found_level == 2

    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import SampledBatchStream
    from repro_torch.models.gnn import GNN
    rng = np.random.default_rng(0)
    gg = gen.erdos_renyi_graph(40, 4.0, seed=1)
    cfg = get_arch("graphsage-reddit").smoke()
    stream = SampledBatchStream(gg, rng.standard_normal((gg.n, 6)),
                                rng.integers(0, 3, gg.n), (3, 2), 4,
                                device="cpu")
    model = GNN(cfg, 6, 3, device="cpu")
    assert model.forward_sampled(stream(0)).shape == (4, 3)

    from repro_torch.data.recsys import MaskedSequenceStream
    from repro_torch.models.bert4rec import Bert4Rec
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import greedy_generate
    lm_cfg = get_arch("qwen2-1.5b").smoke()
    lm = Transformer(lm_cfg, device="cpu")
    prompt = torch.zeros((2, 5), dtype=torch.int32)
    assert greedy_generate(lm, prompt, 3, 8).shape == (2, 3)
    for arch in ("qwen3-8b", "starcoder2-15b", "deepseek-v2-lite-16b",
                 "deepseek-v3-671b"):
        m = Transformer(get_arch(arch).smoke(), device="cpu")
        assert greedy_generate(m, prompt, 3, 24).shape == (2, 3)
    loss, metrics = m.loss({"tokens": torch.zeros((2, 6), dtype=torch.int32),
                            "labels": torch.ones((2, 6), dtype=torch.int32)})
    assert float(loss) > 0 and float(metrics["aux"]) > 0
    assert serve_cli.main(["--arch", "deepseek-v2-lite-16b", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "5",
                           "--max-new", "3"]).shape == (2, 3)
    with tempfile.TemporaryDirectory() as d:
        w = torch.full((2, 3), 0.1, dtype=torch.bfloat16)
        ckpt.save_checkpoint(d, 1, {"w": w})
        back, _ = ckpt.restore_checkpoint(d, {"w": w})
        assert np.array_equal(back["w"], w.float().numpy())
    rec_cfg = get_arch("bert4rec").smoke()
    rec = Bert4Rec(rec_cfg, device="cpu")
    items = MaskedSequenceStream(rec_cfg.n_items, 2, rec_cfg.seq_len,
                                 device="cpu")(0)["items"]
    cands = torch.arange(1, 40, dtype=torch.int32)
    assert rec.retrieval_scores(items, cands).shape == (2, 39)

    from repro_torch.launch import pattern_gnn, train as train_cli, train_lm
    from repro_torch.models import prng
    from repro_torch.optim import adamw, compression, schedules
    from repro_torch.train import trainer
    from repro_torch.train.step import TrainConfig, build_train_step, init_state
    assert train_cli.main(["--arch", "pna", "--steps", "2", "--device", "cpu",
                           "--log-every", "0"]).steps_run == 2
    assert len(pattern_gnn.main(["--device", "cpu", "--steps", "4"])) == 4
    assert train_lm.CONFIG.n_layers == 12
    tc = TrainConfig(compress_grads=True, microbatches=2)
    st, step = init_state(lm, tc), build_train_step(lm, tc)
    st, m = step(st, {"tokens": torch.zeros((2, 6), dtype=torch.int32),
                      "labels": torch.ones((2, 6), dtype=torch.int32)})
    assert int(st["step"]) == 1 and float(m["loss"]) > 0
    ds = get_arch("deepseek-v2-lite-16b").smoke()
    moe = Transformer(ds, device="cpu")
    dtc = TrainConfig(microbatches=2, remat=True)
    st = init_state(moe, dtc)
    st, m = build_train_step(moe, dtc, donate=True)(
        st, {"tokens": torch.zeros((2, 6), dtype=torch.int32),
             "labels": torch.ones((2, 6), dtype=torch.int32)})
    assert int(st["step"]) == 1 and float(m["loss"]) > 0
    assert train_cli.main(["--arch", "deepseek-v2-lite-16b", "--steps", "1",
                           "--device", "cpu", "--log-every", "0"]).steps_run == 1
    assert prng.randint(prng.key(0), 3, 1, 10).shape == (3,)
    assert float(schedules.constant(0)) == 1.0

    from repro_torch import sharding
    from repro_torch.kernels import cost as kcost
    from repro_torch.launch import abstract, cells, dryrun, op_cost, perf_iter, roofline
    from repro_torch.core.engine import sim_prims
    from repro_torch.models import gnn_distributed as gd
    from repro_torch.train.step import param_tree
    from repro_torch.graph import segment_ops
    mean, std = segment_ops.mean_and_std(
        torch.tensor([[2.0]]), torch.tensor([[2.0]]), torch.tensor([2.0]),
        torch.tensor([[1.0]]), torch.tensor([[1.0]]))
    assert float(mean) == 1.0 and abs(float(std) - 1e-6) < 1e-12
    pna = get_arch("pna").smoke()
    pb, _, part = gd.partitioned_batch_from_graph(gg, 6, 3, 2, device="cpu")
    loss_fn = gd.build_distributed_pna_loss(pna, sim_prims(2, "cpu"),
                                            part.n_local)
    assert float(loss_fn(param_tree(GNN(pna, 6, 3, device="cpu")), pb)[0]) > 0
    assert sharding.logical_to_physical(("batch",), sharding.SINGLE_POD) == ("data",)
    assert kcost.bound(kcost.segment_agg_cost(1, 1, 1, 4))[1] == "bytes"
    assert roofline.PEAK_FLOPS == 989e12
    assert abstract.abstract_init(lambda device: (device.type, None))[0] == "meta"
    with tempfile.TemporaryDirectory() as d:
        assert dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--out", d]) == 0
        assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--set",
                            "n_layers=1", "--set", "train_microbatches=2",
                            "--set-shape", "global_batch=2", "--out", d]) == 0
        rec = perf_iter.main(["--arch", "pna", "--shape", "full_graph_sm", "--chips",
                              "2", "--set", "distributed=true", "--out", d])
        assert rec["counted"]["collectives"]["total"] > 0
    assert isinstance(cells.build_cell("bert4rec", "retrieval_cand"), cells.Cell)
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.core.oracle import solution_subgraph_oracle
    from repro_torch.core.state import solution_counts
    from repro_torch.serve.engine import build_recsys_scorer
    assert get_config("pna") is get_arch("pna").CONFIG and "molecule" in get_shapes("gin-tu")
    assert solution_subgraph_oracle(g, t)[0].all()
    assert solution_counts(res.state)["active_vertices"] == 4
    assert gen.clique_graph(4, [0] * 4).m == 12 and gen.path_graph(3, [0] * 3).m == 4
    assert build_recsys_scorer(Bert4Rec(rec_cfg, device="cpu"), "retrieval")(
        items, cands).shape == (2, 39)
    with op_cost.OpCounter() as counter:
        torch.ones(2, 3) @ torch.ones(3, 4)
    assert counter.flops_f32 == 48

    import torch.distributed as dist
    from repro_torch.launch import mesh as rmesh
    from repro_torch.sharding import gather_tree
    from repro_torch.train.step import shard_state, state_shardings
    with tempfile.TemporaryDirectory() as d:
        rmesh.make_shard_group(1, backend="gloo", init_method=f"file://{d}/rdv", rank=0)
        one = rmesh.make_rank_mesh((1, 1))
        ltc = TrainConfig(microbatches=2, remat=True)
        sh = state_shardings(moe, ltc, one)
        st = shard_state(init_state(moe, ltc), sh, one)
        st, m = build_train_step(moe, ltc, mesh=one)(
            st, {"tokens": torch.zeros((2, 6), dtype=torch.int32),
                 "labels": torch.ones((2, 6), dtype=torch.int32)})
        assert float(m["loss"]) > 0
        ckpt.save_checkpoint(d, 1, st, mesh=one, specs=sh)
        back, meta = ckpt.restore_checkpoint(d, st, device="cpu", mesh=one, specs=sh)
        assert int(meta["step"]) == 1 and torch.equal(
            gather_tree(back, sh, one)["params"]["embed"], st["params"]["embed"])
        rep = trainer.run(st, build_train_step(moe, ltc, mesh=one), lambda i: {
            "tokens": torch.zeros((2, 6), dtype=torch.int32),
            "labels": torch.ones((2, 6), dtype=torch.int32)}, num_steps=2,
            ckpt_dir=d, mesh=one, specs=sh)
        assert rep.steps_run == 1
        dist.destroy_process_group()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    if torch.cuda.is_available():
        assert prune(g, t).state.omega.device.type == "cuda"
        assert prune_batch(g, [t]).results[0].dg.device.type == "cuda"
        assert IncrementalSession(g, t).dg.device.type == "cuda"
        assert GNN(cfg, 6, 3).device.type == "cuda"
        assert Transformer(lm_cfg).device.type == "cuda"
        assert Bert4Rec(rec_cfg).device.type == "cuda"
    else:
        for name, call in (("prune()", lambda: prune(g, t)),
                           ("quickstart", lambda: quickstart.main([])),
                           ("prune_batch()", lambda: prune_batch(g, [t])),
                           ("prune_batch(partition=2)",
                            lambda: prune_batch(g, [t], partition=2)),
                           ("GraphQueryEngine()", lambda: GraphQueryEngine(g)),
                           ("GraphQueryEngine(partition=2)",
                            lambda: GraphQueryEngine(g, partition=2)),
                           ("IncrementalSession()",
                            lambda: IncrementalSession(g, t)),
                           ("exploratory_search()",
                            lambda: exploratory_search(g, t)),
                           ("serve --graph-queries", lambda: serve_cli.main(
                               ["--graph-queries", "2", "--graph-scale", "6"])),
                           ("interactive_search",
                            lambda: interactive_search.main([])),
                           ("GNN()", lambda: GNN(cfg, 6, 3)),
                           ("Transformer()", lambda: Transformer(lm_cfg)),
                           ("Transformer(deepseek)", lambda: Transformer(
                               get_arch("deepseek-v2-lite-16b").smoke())),
                           ("Bert4Rec()", lambda: Bert4Rec(rec_cfg)),
                           ("launch.train", lambda: train_cli.main(
                               ["--arch", "pna", "--steps", "1"])),
                           ("launch.pattern_gnn",
                            lambda: pattern_gnn.main(["--steps", "1"])),
                           ("partitioned_batch_from_graph()",
                            lambda: gd.partitioned_batch_from_graph(gg, 6, 3, 2))):
            try:
                call()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError(f"{name} without device= ran on the CPU")
    print("isolated")
""")


def test_port_runs_without_jax_or_the_reference_package():
    # two torch threads, as the other port test files run (torch_train_util)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "2"}
    env.update({k: v for k, v in os.environ.items()
                if k in ("HOME", "TMPDIR", "LD_LIBRARY_PATH")})
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("isolated")


def test_no_port_source_imports_jax_or_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if IMPORT_RE.match(line)]
    assert not bad, bad
