#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and `nvcc`:

1. device   prints the card and its power limit, builds the CUDA kernels
            from `src/repro_torch/kernels/csrc/` and prints the build time;
2. kernels  a. holds `bitset_spmm` and `bitset_wave` against their plain
               PyTorch versions on the card, bit-exact: `bitset_spmm` at
               W = 1 and 2 also on a hub of 120,000 in-arcs and on runs that
               start on the edge-balanced kernel's chunk boundaries;
               `bitset_wave` on that hub graph at W in {1, 2, 4, 32, 48} x
               L in {1, 3, 6}, with the hub live in every hop and in
               alternate hops, random candidacy words, a hop without
               candidates, every vertex a candidate, two calls back to back
               and one call under sync debug mode (`wave_checks`);
            b. times both at the shapes of the R-MAT scale-20 main path
               beside their bounds, with the bytes the W = 1 sweep moves;
               the wave also with every vertex a candidate;
3. parity   runs prune + count on R-MAT scale 14 on the card (kernels) and
            on the CPU (plain versions) and requires identical omega, edge
            mask, phase trajectory and match count; the three NLCC routes on
            the card must agree too;
            b. the same graph with the frontier edge-prune pass
               (`nlcc_edge_prune=True`), card against CPU: omega, edge mask,
               trajectory with `nlcc_edges_pruned`, lcc_iterations; the
               device join against the host join (rows and counts) on both
               devices and across them; the union of `stream_matches`
               against the materialized set;
            c. a repeated-label triangle with thousands of matches, card
               against CPU: the edge-prune prune (no fast path); the device
               join against the host join in count and materialize mode,
               with the seconds of each on the card; `stream_matches` and
               the chunk back-off under a row budget that splits blocks and
               overflows single sources, each equal to the materialized set;
4. full     the main path at R-MAT Graph500 scale 20 (edge factor 16, degree
            labels, seed 3): prune and count-mode enumeration on the card,
            with per-phase seconds, peak device memory and the launch count
            of each prune kernel, which must be nonzero; device time by
            kernel and the busy share over one more prune (torch.profiler);
            then the planted-needle quickstart scenario;
            b. the edge-prune prune of the same template: per-phase seconds,
               peak memory, launches (both kernels nonzero), V*/E* beside
               the default prune's; omega and the edge mask equal the
               default prune's, and both keep exactly what the matches use;
               every `bitset_wave` call of one more such prune (the pass's
               one-hop calls over the graph and its reverse, and the fused
               waves) held bit for bit against the plain version; the count
               by the device join and by the host join with the seconds of
               each;
            c. `collect_graph_stats` and `plan_query` seconds; `tune` of the
               LCC sweep, NLCC wave and join routes at this size (cache in a
               temporary directory under `experiments/`), the measured
               candidates; the prune under the tuned policy and under a
               recorded plan, each equal to the untuned prune;
            d. `python -m repro_torch.launch.quickstart` in its own process.
5. GNN      the GNN inference path (GraphSAGE's sampled forward):
            a. `segment_agg` against its plain version on the card over
               NT x D x F in {1,7,16,33} x {1,4,10,25} x {1,3,128,602}, f32
               and bf16, with all-False rows and NaN / Inf in masked slots:
               min and max bit-exact, sum and sum of squares within
               rtol = atol = 1e-5;
            b. its times and the plain version's beside the bound at the
               three shapes of the full-width forward;
            c. card against CPU, logits within rtol = atol = 1e-4: the
               graphsage-reddit config on a small graph (one batch of 64
               seeds), and the pattern-filtered PNA scenario of
               examples/pattern_gnn.py (identical pruned graph and omega);
            d. full width: graphsage-reddit on the minibatch_lg shape
               (1024 seeds, fanouts 15-10, 602 features, 41 classes) over an
               Erdos-Renyi graph of the shape's size (232,965 vertices,
               114,615,892 arcs), the feature table resident on the card:
               ten batches with host sampling and device seconds, the loss,
               peak device memory, and `segment_agg` launches, which must be
               3 per batch; the first batch's logits equal a CPU forward;
               then device time by kernel and the device's busy share over
               three more batches (torch.profiler).
6. LM       qwen2-1.5b prefill and greedy serving:
            a. `flash_attention` against its plain version on the card: the
               six shapes of tests/test_kernels.py, S in {1, 77, 1000} at
               D = 64 with causal off and windows, D = 256, a strided k/v
               view; f32 through the CUDA-core kernel, bf16 through the
               tensor-core kernel (tolerances in `attention_checks`), each
               call's variant read from the launch counts;
            b. the tensor-core kernel's registers and spills (ptxas), its
               times (CUDA events; device time without the host's cost
               between calls, see `kernel_device_ms`), the plain version's
               and SDPA's beside the bound, bf16 causal, at one prefill_32k
               sequence [1,12/2,32768,128] and the serving prefill
               [8,12/2,2048,128], each output checked as in 6a, with the
               share of its allowance it used;
            c. card against CPU: qwen2-1.5b at full width cut to 2 layers,
               f32, B=2 S=256 prompts: last logits within LM_PARITY_TOL and
               8 greedy tokens equal;
            d. full width (28 layers, bf16, random weights): the prefill_32k
               program on one sequence of 32,768 tokens, then greedy serving
               of 8 requests of 2,048-token prompts and 64 new tokens, with
               seconds, peak memory and exactly 28 `flash_attention`
               launches each, all of the tensor-core kernel; then a decode
               step's device time (CUDA events over replays of the step
               captured in a CUDA graph) and the device's busy share over
               eager decode steps alone and over a serving prefill;
            e. the serving CLI (`launch/serve.py --arch qwen2-1.5b`) on the
               card, with the config it serves there.
7. recsys   bert4rec scoring and retrieval:
            a. `embedding_bag` against its plain version on the card: the
               four cases of tests/test_kernels.py, L in {1, 4, 32} x D in
               {32, 64, 128, 602}, sum and mean, f32 and bf16 tables,
               negative and out-of-range ids, an unaligned table;
            b. its times, the plain version's and F.embedding_bag's beside
               the bound at the retrieval_cand shape (1,000,000 bags of one
               id over the [1,000,002, 64] bf16 table);
            c. card against CPU: the bert4rec smoke config in f32, catalog
               and retrieval scores within LOGIT_TOL;
            d. full width: serve_p99 (512 users, top-10 of the catalog) and
               retrieval_cand (1 user x 1,000,000 candidates, exactly one
               `embedding_bag` launch), seconds and peak memory;
            e. the serving CLI (`launch/serve.py --arch bert4rec`).
8. many     many queries against one graph (run with the prune path, on
            its graphs):
            a. R-MAT scale 14, card against CPU: `prune_batch` of the 8
               templates of tests/test_batch.py (labels moved up by 3 to
               this graph's degree labels), its straggler pair at wave 32
               and a deadline that passes in the middle of the run (a
               ticking fake clock): statuses, counters, and each lane's
               omega, edge mask and count equal on both devices and to the
               single prune of its template; `GraphQueryEngine` in count
               mode (the single prunes' counts) and stream mode (the rows of
               `enumerate_matches`); the incremental session and the
               exploratory search of examples/interactive_search.py, card
               == CPU;
            b. scale 20, the phase-4 graph: `GraphQueryEngine` serves
               `example_workload(32)` in prune mode in batches of 8, without
               the complete-walk TDS (`SERVE_PRECISION` says why): q/s,
               seconds per batch beside the 32 single prunes' seconds, the
               batched counters, peak memory, launches per batch (both
               kernels nonzero), each lane's omega and edge mask equal to
               its single prune's; then a batch of 6 with the complete TDS
               (`SERVE_TDS_BATCH`), each lane equal to its single prune;
               the profiler over one more batch;
            c. scale 20: `IncrementalSession` over the example's three
               revisions, seconds and constraints reused per revision, each
               revision keeping every vertex of the exact prune, inside the
               candidate set, both kernels launched; `exploratory_search` on
               the example's planted-squares recipe at scale 20 over 1,000
               labels, its levels, the squares found at k = 2;
            d. `launch/serve.py --graph-queries 32 --graph-scale 14` and
               `launch/interactive_search` in processes of their own.
9. sharded  the prune and enumeration on a partitioned graph (run with the
            prune path, on its graphs), `bitset_spmm` as each shard's
            receive-side OR (`ops.bitset_segment_or`):
            a. scale 14, `prune(partition=P)` (the sim backend) at P in
               {1, 2, 4, 8} for hex-unique and the 3c triangle, card against
               the CPU sim and the card's local prune: omega, edge mask,
               trajectory, lcc_iterations (card == CPU), the count through
               both sharded joins; every `bitset_segment_or` call of the
               P = 4 prunes bit-exact against the plain version;
            b. scale 18 (its own graph, the same generator and seed; 9c-10c
               share it), hex-unique at P = 2 (wave 1024) and P = 4 (wave
               512): each prune equal to the local prune of that graph and
               keeping exactly what its matches use, the count by both
               flavors; B, slots, padding, plane size, seconds by phase and
               by flavor, peak memory, `bitset_spmm` launches, the busy
               share, and the first sweep's gather, exchange, receive (with
               its plain version and bound) and twin test by CUDA events;
               that receive and one hop's at the wave's width bit-exact
               against the plain version, and every `bitset_segment_or`
               call of one more prune at each P;
            c. scale 18, `prune(mesh=group)` on an NCCL group of one rank
               (one card holds one NCCL rank) equal to the sim at P = 1 and
               to the local prune.
10. faults  resilience, the paper's checkpoint-and-rebalance and sharded
            batches (run with the prune path, reusing 9b's and 9c's
            partitions; 10b and 10c run first, while a worker process,
            started with the prune path, computes 10a's CPU side):
            a. scale 14, the scenarios of tests/test_torch_resilience.py on
               the sim at P = 4 for hex-unique and the 3c triangle: a shard
               loss at each phase boundary and in the middle of a wave,
               restarting onto P = 2, a seeded random plan, a collective
               retried in place, a kernel fault that reaches the ref rung
               (the plain versions on the card, counted), a chunk
               back-off, a skew-triggered rebalance; each equal to the
               fault-free card prune (itself equal to the local prune),
               its ladder, restarts, rebalances and fired faults equal to
               the CPU run's, and no plain-version call outside the ref
               rung; `prune_batch` of 8a's templates at P = 2 and 4, each
               lane equal to its single sharded prune and to the CPU's,
               every receive-side call of the P = 4 batch bit-exact
               against the plain version;
            b. scale 18, hex-unique from the sim at P = 4 (wave 512) with a
               checkpoint at every phase: (i) a shard loss at phase 1
               restarted onto P = 2, (ii)-(iv) the rebalance triggered at
               the first boundary onto P = 4, 1 (the local backend) and 2,
               (v) a collective timeout retried on one NCCL rank; each
               equal to 9b's local prune with no plain-version call and its number
               of moves as expected (two onto P = 4, the second at the
               next boundary); prune seconds beside 9b's and the moves'
               share of them, checkpoint bytes and seconds, restore and
               handoff seconds, the compacted graph's n, m, B and padding,
               the skew before and after, peak memory;
            c. scale 18, `prune_batch` of 4 same-bucket templates at P = 2
               with the largest wave of 64 and 32 that the lockstep group
               budget allows (read after the allocator's cache is
               emptied), each lane equal to its single P = 2 prune and to
               the P = 1 batch;
               `GraphQueryEngine(partition=)` serving 8 counted queries
               against the one-shard engine; `launch/serve.py
               --partition 2` in its own process.

11. train   the training path (`train/step.py`, `train/trainer.py`), the
            gradients of `segment_agg` and `flash_attention` through their
            autograd Functions (the kernel forward, the plain backward):
            a. card against CPU at smoke size, 3 steps from one state: the
               four GNNs on a full graph, sampled GraphSAGE (segment_agg
               launched), the pattern-filtered PNA of
               examples/pattern_gnn.py (5 steps), qwen2 smoke at head dim
               64 with plain CE, fused_ce, remat True and "dots", 2
               microbatches and compressed gradients (flash_attention
               launched), bert4rec smoke with its three objectives; losses
               and parameters within TRAIN_LOSS_TOL and TRAIN_PARAM_TOL;
               then `launch/pattern_gnn.py` in its own process;
            b. each backward against autograd through its plain forward on
               the card: segment_agg at 5d's three shapes, f32 and bf16,
               with tied minima and maxima; flash_attention bf16 causal at
               [1,12/2,4096,128] and [8,12/2,2048,128] against f32
               autograd of `ref.attention_ref`, its forward held to the
               plain version as in 6b; the plain backwards' times
               beside their bounds and SDPA's autograd backward;
            c. graphsage-reddit training on minibatch_lg over 5d's graph and
               stream (run inside the GNN path, right after 5d, so the
               stream leaves the card before phases 6 and 7): 10 AdamW steps, seconds per step by sampling, gather
               and forward + backward + update, the loss, peak memory, 3
               segment_agg launches a step, the busy share;
            d. qwen2-1.5b at full width (28 layers, bf16 parameters, f32
               AdamW moments) on train_4k cut to 2 sequences as 2
               microbatches of 1 x 4096 tokens with full remat, 3 steps:
               seconds, tokens/s, peak memory, the loss, 112
               flash_attention launches a step (56 of them remat's
               recomputed forwards, counted by the registry as launches
               inside the backward), all on the tensor-core kernel, the
               busy share;
            e. bert4rec at full width (1,000,002 x 64 bf16), train_batch
               cut to 8 users x 200 positions, full-catalog softmax, 3
               steps: seconds and peak memory;
            f. the trainer with a SimulatedFailure at step 3 of 6 and a
               checkpoint every 2 steps in a temporary directory, in its
               own process under torch.use_deterministic_algorithms(True):
               the losses equal the uninterrupted run's.
12. LM archs the four other LM architectures (run last, `run_lm_archs`):
            a. `flash_attention` at MLA's (Dqk, Dv) = (192, 128) against its
               plain version, f32 and bf16, causal, [1, H, S, 192/128] at H
               in {16, 128} x S in {1, 77, 1000, 4096} and with v a view of
               the kv projection (tolerances of 6a); ptxas's registers and
               spills of the new instantiations; its times at one
               deepseek-v2-lite prefill_32k sequence [1,16,32768,192/128]
               bf16 causal beside the bound, the plain version and SDPA
               (memory-efficient: Ev != E);
            b. card against CPU, each arch at full width cut to 2 layers in
               f32 (deepseek: 1 dense + 1 MoE layer; deepseek-v3's routed
               experts cut from 256 to 16 for the host's memory, top-8;
               starcoder2's window cut to 64, a 56-token prompt and 24 new
               tokens, so decode wraps the ring): last logits within
               LM_PARITY_TOL and greedy tokens equal, the card's prefills
               all on the f32 kernel;
            c. full width in bf16 (deepseek-v3 cut to 4 layers, 3 dense + 1
               MoE of 256 experts, and its MTP block), one arch at a time:
               the prefill_32k program on one sequence and greedy serving
               (qwen3-8b and deepseek-v2-lite 8 x 2,048 + 32 tokens,
               starcoder2 4 x 4,064 + 64 so that decode crosses position
               4096, deepseek-v3 4 x 1,024 + 16): seconds, tokens/s, decode
               ms per token, peak memory, exactly n_layers `flash_attention`
               launches each, all bf16_tc, no plain-version call on the
               card; the profiler over one more prefill_32k; starcoder2 in
               f32 at 2 layers: 4 decode steps past 4096 equal to the
               kernel's windowed forward of the same prefix; deepseek-v3's
               loss (MTP and the aux loss) on 1 x 4,096 tokens without
               gradients, finite, n_layers + 1 launches;
            d. the train step card against CPU at each arch's smoke size
               (head dims raised as `serve_config` raises them), f32, 2
               microbatches, full remat, deepseek-v3 with its cell's bf16
               moments: 3 steps within 11a's bounds, the smallest gap
               between a token's k-th and (k+1)-th router probability on
               either device, remat's recomputed routing equal to the
               forward's;
            e. qwen3-8b, starcoder2-15b and deepseek-v2-lite training at
               full width in bf16, cut to 12, 8 and 1 + 4 layers
               (LM_ARCH_TRAIN_CUT, each reckoned by the dry run of the cut
               cell), train_4k cut to 2 x 4,096 tokens as 2 microbatches,
               full remat, the state donated, 3 steps: the reckoning beside
               the measured peak, seconds and tokens/s, the first loss
               within LM_PARITY_TOL of the same weights' f32 loss,
               2 x 2 x layers flash_attention launches a step (half inside
               the backward), all bf16_tc, no plain forward, no host read
               inside an MoE layer (sync debug mode "error"), the busy
               share over one more step;
            f. the tensor-core kernel at those train shapes beside its bound
               and SDPA, and the plain backward at MLA's pair
               ([1,16/16,4096,192/128], [1,128/128,1024,192/128]) as 11b.
13. sharded GNN  the sharded PNA step on the sim backend, the dry run of
            every cell and four cells on the card under the cost counter
            (`run_sharded_gnn`).
14. sharded LM  the LM train step on a (2, 2) (data, model) mesh of four
            gloo ranks sharing the card (NCCL refuses two ranks on one
            GPU; a collective's tensors staged through page-locked host
            memory), spawned after the parent frees its memory, with a
            `file://` rendezvous (`run_sharded_lm`, run last):
            a. the five archs' smoke step (12d's), 3 steps from one state,
               held to the single-process step on the card within 11a's
               bounds; `flash_attention` launched on every rank's local
               heads, the f32 kernel, as often as the step should;
            b. qwen3-8b (8 of 36 layers) and deepseek-v2-lite (1 dense + 2
               MoE layers, 32 of 64 experts a model rank) at full width in
               bf16, 2 x 4,096 tokens a step (a sequence a data rank),
               remat, the state donated: each rank's reckoning on the meta
               device (the four with their contexts within 85% of 80 GiB),
               seconds a step, tokens/s, each rank's peak, the share of the
               step in the collectives by kind; the first loss within
               LM_PARITY_TOL of the single-process bf16 loss of the whole
               batch, its CE and aux terms apart, and each MoE layer's
               first routing (top-k sets and drops) against it;
            c. the 14a step on a (1, 1) mesh over a one-rank NCCL group, in
               its own process under deterministic algorithms, bit for bit
               the single-process step;
            d. qwen2's smoke step: 3 steps at (2, 2), the checkpoint
               (gathered, rank 0 writing), restored onto (3, 1), step 4
               there, held to an uninterrupted 4-step run within 11a's
               bounds.

Every time is printed beside the card's name and power limit. The line
before the last is a JSON object listing each kernel with its launches on
its path's run, its error against the plain version and its times, all
measured in this run (`bound_ms` computed from this run's inputs); the
last line is
{"ok": true, "device": {...}}. Without a CUDA device,
or when any check fails, the script exits non-zero and prints no result.
"""
import contextlib
import copy
import dataclasses
import json
import re
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import GNN_CLASSES, LMConfig  # noqa: E402
from repro_torch.core import engine, lcc, nlcc, planner  # noqa: E402
from repro_torch.core.batch import prune_batch  # noqa: E402
from repro_torch.core.engine import sim_prims  # noqa: E402
from repro_torch.core.enumerate import (  # noqa: E402
    ENUM_ROUTE, count_matches, enumerate_matches, stream_matches)
from repro_torch.core.exploratory import exploratory_search  # noqa: E402
from repro_torch.core.incremental import IncrementalSession  # noqa: E402
from repro_torch.core.lcc import TemplateDev, lcc_fixpoint  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.state import (  # noqa: E402
    init_state, pack_bits, seeded_frontier, unpack_bits)
from repro_torch.core.template import Template, generate_constraints  # noqa: E402
from repro_torch.data.graphs import (  # noqa: E402
    PatternFilteredDataset, SampledBatchStream, full_graph_batch)
from repro_torch.data.recsys import MaskedSequenceStream  # noqa: E402
from repro_torch.data.tokens import SyntheticTokenStream  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.partition import partition_graph  # noqa: E402
from repro_torch.graph.stats import collect_graph_stats  # noqa: E402
from repro_torch.graph.structs import DeviceGraph, Graph  # noqa: E402
from repro_torch.kernels import build, ops, ref, registry  # noqa: E402
from repro_torch.kernels.cost import (  # noqa: E402
    attention_cost, bound, embedding_bag_cost, segment_agg_backward_cost,
    segment_agg_cost)
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.op_cost import OpCounter, counted_step  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as PEAK_BF16_FLOPS_PER_S, Roofline)
from repro_torch.launch import interactive_search, pattern_gnn  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.bert4rec import Bert4Rec  # noqa: E402
from repro_torch.models import gnn as gnn_mod, gnn_distributed as gd  # noqa: E402
from repro_torch.models.common import nest  # noqa: E402
from repro_torch.models.gnn import GNN  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.tree import leaves, tree_map, unflatten  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.step import TrainConfig, build_train_step, param_tree  # noqa: E402
from repro_torch.train.step import init_state as init_train_state  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    MODE_COUNT, MODE_PRUNE, MODE_STREAM, GraphQueryEngine, example_workload)
from repro_torch.serve.engine import build_decode_step, build_prefill, greedy_generate  # noqa: E402

SEED = 3
EDGE_FACTOR = 16
SCALE_PARITY = 14
SCALE_FULL = 20
# phases 9b, 9c, 10b and 10c: their host partitions and join plans took
# 23-29 s each at scale 20; at 18 about a quarter (R-MAT with the same edge
# factor, degree labels and seed), held to a local prune of that graph
SCALE_SHARDED = 18
# The main path's template: the unique-label 6-cycle "hex-unique" of
# benchmarks/frontier_edge_prune.py. RMAT-2 (benchmarks/rmat_distributions.py)
# is pruned empty by the first LCC on degree-labelled R-MAT, so no NLCC wave
# would run; phase 4 reports that too.
HEX = ([3, 4, 5, 6, 7, 8], [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)])
RMAT2 = ([2, 3, 4, 5, 6, 7, 1],
         [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (1, 6)])
WAVE = 1024
# Phase 3c: a template with thousands of matches at scale 14, for the joins
# at many rows: the triangle of label-7 vertices (degree 64-127), 11,820
# embeddings on the degree-labelled scale-14 R-MAT graph. Its streaming and
# overflow runs take a row budget and a chunk small enough that row blocks
# split, chunks back off and single sources overflow into the streaming
# emitter.
TRI_MANY = ([7, 7, 7], [(0, 1), (1, 2), (2, 0)])
JOIN_TIGHT_ROWS, JOIN_TIGHT_CHUNK = 1024, 256
# Phase 8, many queries against one graph. 8a batches the templates of
# tests/test_batch.py (cyclic, path, counted and TDS-bearing ones of one
# shape bucket) with their labels moved up by BATCH_LABEL_SHIFT to this
# graph's degree labels (the reference's scale-8 graph has labels 0-7, the
# scale-14 graph 0-12), where every lane keeps matches, and that file's
# straggler pair (a one-vertex head beside a wide one, wave 32); 8b serves
# example_workload(32) in batches of 8.
BATCH_VARIANTS = [
    ([5, 4, 4, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    ([5, 4, 3, 2], [(0, 1), (1, 2), (2, 3)]),
    ([4, 3, 3], [(0, 1), (1, 2), (2, 0)]),
    ([6, 5, 4, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    ([3, 2, 2, 2], [(0, 1), (1, 2), (2, 3)]),
    ([5, 5, 4], [(0, 1), (1, 2), (2, 0)]),
    ([4, 4, 3, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    ([6, 4, 2], [(0, 1), (1, 2), (2, 0)]),
]
BATCH_LABEL_SHIFT = 3
BATCH_STRAGGLERS = [([8, 3, 8], [(0, 1), (1, 2), (2, 0)]),
                    ([6, 5, 6], [(0, 1), (1, 2), (2, 0)])]
BATCH_COUNTERS = ("lcc_iterations", "nlcc_waves", "nlcc_tokens",
                  "nlcc_lockstep_padded", "nlcc_constraints", "nlcc_host_syncs",
                  "tds_gather_bridge")
SERVE_QUERIES, SERVE_MAX_BATCH = 32, 8
# 8b prunes without the precision-guaranteeing complete-walk TDS. With it the
# workload is bound by that host phase on the graph's dense core (labels
# 10-14): on an H100 machine, 30-61 s a query for the [10,11,12],
# [11,12,13] and [12,12,13] triangles and the [10,11,12,13] square, and the
# [11,12,13,14] square overflows tds_max_rows (57,552,476 partial rows from
# one source), in the single prune as in the reference's design. Without
# it, every query is LCC and NLCC waves on the card.
SERVE_PRECISION = False
# 8b also prunes this same-bucket batch with the complete TDS: templates of
# example_workload's shapes whose single prunes with it took 0.06-0.26 s
# each on an H100 machine, on this graph
SERVE_TDS_BATCH = [
    ([3, 4, 5, 6], [(0, 1), (0, 3), (1, 2), (2, 3)]),
    ([5, 5, 6], [(0, 1), (0, 2), (1, 2)]),
    ([6, 6, 7], [(0, 1), (0, 2), (1, 2)]),
    ([5, 6, 7], [(0, 1), (0, 2), (1, 2)]),
    ([10, 10, 11], [(0, 1), (0, 2), (1, 2)]),
    ([9, 10, 11], [(0, 1), (0, 2), (1, 2)]),
]
# 8c's planted-squares recipe at scale 20 draws labels from this many (the
# example's 50 at scale 10). With 50, label 44 marks 21,000 vertices of
# the scale-20 background, which hold natural 4-cliques found at k = 0;
# with 1,000 it marks about 1,000, among which about 6 background edges
# are expected, so the planted squares are found at k = 2
EXPLORE_LABELS_FULL = 1000
# 8d serves the CLI's workload at this scale: in count mode at scale 20 the
# CLI's graph (edge factor 8) holds triangles of 2.2 M matches whose
# complete TDS and host count take 72 s on an H100 machine, and 32 queries
# did not finish in 700 s; at scale 16 they took 123 s, at scale 18 228 s.
SERVE_CLI_SCALE = 14
DEVICE = "cuda"
# Phase 5: graphsage-reddit on the minibatch_lg shape, over an Erdos-Renyi
# graph of that shape's size (Reddit: 232,965 vertices, 114,615,892 arcs).
GNN_ARCH = "graphsage-reddit"
GNN_SHAPE = "minibatch_lg"
GNN_BATCHES = 10
GNN_PARITY_N = 3000
GNN_PARITY_SEEDS = 64
AGG_TOL = 1e-5   # segment_agg sums: f32, another order of the same terms
LOGIT_TOL = 1e-4  # forward passes: f32 matmuls in another order
# Phase 6: qwen2-1.5b. Card vs CPU at full width cut to 2 layers, in f32;
# the prefill_32k program on one sequence (global_batch 32 cut to 1, one
# chip); serving 8 requests of 2,048-token prompts and 64 new tokens (the
# decode_32k batch of 128 cut to 8).
LM_ARCH = "qwen2-1.5b"
LM_PARITY_LAYERS, LM_PARITY_BATCH, LM_PARITY_LEN, LM_PARITY_NEW = 2, 2, 256, 8
LM_PREFILL_SHAPE = "prefill_32k"
LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_NEW = 8, 2048, 64
# decode steps timed (graph replays) and profiled (eager) after the serving run
LM_DECODE_TIMED, LM_DECODE_PROFILED = 16, 8
# flash_attention timing shapes (B, Hq, Hkv, S, D, timed calls): one
# prefill_32k sequence, and the serving prefill
ATTN_TIMING_SHAPES = [(1, 12, 2, 32768, 128, 3), (8, 12, 2, 2048, 128, 10)]
ATTN_F32_TOL = 1e-4   # flash_attention f32: sums of S terms in another order
# flash_attention bf16 (attention_checks, attention_weights): p's largest
# relative move when it is rounded to bf16 (the unit roundoff of 8
# significant bits) and when its rounding flips (one bf16 ulp); the relative
# difference of the kernel's unrounded p from the blockwise version's (f32
# logits summed in another order, exp2 of log2 units), within which a p
# near a bf16 rounding midpoint may round either way; and the f32 sums of
# p |v| in another order. Each times a sum of the softmax weights with |v|.
ATTN_P_ROUND, ATTN_P_FLIP = 2.0 ** -8, 2.0 ** -7
ATTN_P_EPS, ATTN_F32_SLACK = 2.0 ** -13, 2.0 ** -16
ATTN_TOLERANCE = (
    f"f32 (CUDA cores) rtol=atol={ATTN_F32_TOL}; bf16 (tensor cores), A and F "
    "the softmax weights' sums with |v| over every key and over the keys whose "
    "p is within 2^-13 of a bf16 rounding midpoint: (i) 2 ulps + 2^-7 F + "
    "2^-16 A of the blockwise version at the kernel's kv tile, (ii) 2 ulps + "
    "(2^-8 + 2^-12 + 2^-16) A of f32 arithmetic rounded once (max_abs_err)")
LM_PARITY_TOL = 1e-3  # last logits card vs CPU: 1536-wide f32 products, 2 layers
# Phase 7: bert4rec; the retrieval_cand shape is 1,000,000 bags of one id
# over the [1,000,002, 64] item table.
RECSYS_ARCH = "bert4rec"
BAG_TOL = 1e-5        # embedding_bag f32: sums of at most L products
# a device-side spin of about 25 ms at the H100's 1.98 GHz boost clock, ahead
# of a timed burst of launches (kernel_device_ms)
SPIN_CYCLES, SPIN_MS = 50_000_000, 25.0


# the card's name and power limit as nvidia-smi reads them (phase 1), printed
# beside every time
# Phase 9, a sharded graph: the sim backend at every P of tests/
# test_torch_sharded.py at scale 14 (9a); at scale 20 (9b) at P = 2 with the
# main path's wave and at P = 4 with wave 512, which keeps a frontier plane
# (P*P*B slots x wave/32 words) near 10 GiB (18.6 GiB at wave 1024; P = 8
# would need 40 GiB a plane, so it runs in 9a only).
SHARDS_PARITY = (1, 2, 4, 8)
SHARDED_FULL = ((2, 1024), (4, 512))
SHARD_FLAVORS = ("rowsharded", "replicated")
CARD = "card not read"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg=""):
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers
def random_words(rng, n, w, device):
    """int32[n, w] words drawn over all 32 bits (bit 31 included)."""
    raw = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    return torch.from_numpy(raw.view(np.int32)).to(device)


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def reset_peak():
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else 0.0


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def time_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events, after one
    warm-up call."""
    fn()
    sync()
    if DEVICE != "cuda":  # a rehearsal on the CPU: no device time exists
        return float("nan")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """(fn(), its seconds on the host's clock, the device synchronized
    before and after)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def spmm_cost(dg, edge_active, w):
    """(bytes, operations) that one bitset_spmm call must at least spend on
    these inputs, each input read once: the active flag of every arc, the
    source of every active arc, the dst offsets, each vals row an active arc
    reads, and n rows written; one OR per word per active arc."""
    active = int(edge_active.sum())
    rows = int(torch.unique(dg.src[edge_active]).numel())
    nbytes = dg.m + active * 4 + (dg.n + 1) * 8 + rows * 4 * w + dg.n * 4 * w
    return nbytes, active * w


def wave_cost(dg, edge_active, cand, w):
    """(bytes, operations) that the L hops of bitset_wave must at least spend
    on these inputs, each input read once: the L candidacy rows, the offsets
    and in-arcs (active flag, and source if active) of every vertex that is a
    candidate in some hop, the vals rows the first hop reads, and the [n, W]
    output written once. The frontiers between hops are the function's own
    and need not leave the chip, so they count no bytes. Operations: per hop,
    one OR per word per active in-arc of a candidate and one AND per word per
    candidate."""
    live = cand != 0                                        # bool[L, n]
    any_live = live.any(0)
    deg = dg.dst_ptr[1:] - dg.dst_ptr[:-1]
    active_in = torch.bincount(dg.dst[edge_active].long(), minlength=dg.n)
    first = edge_active & live[0][dg.dst.long()]
    rows = int(torch.unique(dg.src[first]).numel())
    nbytes = (dg.n * 4 * w + cand.numel() * 4 + int(any_live.sum()) * 16
              + int(deg[any_live].sum()) + int(active_in[any_live].sum()) * 4
              + rows * 4 * w)
    ops = sum((int(active_in[live[r]].sum()) + int(live[r].sum())) * w
              for r in range(cand.shape[0]))
    return nbytes, ops


def trajectory(res):
    return [(p.phase, p.active_vertices, p.active_edges, p.omega_bits)
            for p in res.phases]


def first_wave_inputs(dg, template, state, label_freq):
    """The packed frontier and candidacy words of the main path's first NLCC
    wave (first walk of the first cycle constraint) from `state`."""
    c = next(c for c in generate_constraints(template, label_freq=label_freq)
             if c.kind == "cycle")
    walk = nlcc.expand_walks(c)[0]
    omega = state.omega
    sources = np.flatnonzero(omega[:, walk[0]].cpu().numpy())
    check(sources.size > 0, "no wave sources after the initial LCC")
    ids, _ = next(nlcc.wave_batches(sources, WAVE))
    ids = torch.from_numpy(ids.astype(np.int64)).to(omega.device)
    cand_bool = torch.stack([omega[:, q] for q in walk], dim=0)
    return seeded_frontier(ids, cand_bool[0], dg.n), nlcc.hop_words(cand_bool)


# ------------------------------------------------------------------- phases
def phase_device():

    global CARD
    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
    name = torch.cuda.get_device_name(0)
    log(f"torch.cuda.get_device_name: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"({build.library_path().name})")
    for fn, line in ptxas_report(""):
        log(f"  ptxas {fn}: {line}")
    return name


def spmm_edge_graphs(rng):
    """Graphs that probe the edge-balanced bitset_spmm at W <= 2 (a warp per
    ops.BITSET_ARC_CHUNK dst-sorted arcs): one hub with 120,000 in-arcs,
    spread over hundreds of chunks, beside 20,000 other arcs; and runs of
    exactly one chunk for vertices 0 and 1, so that vertex 1's run starts on
    a chunk boundary, then 77 arcs, so that m is not a multiple of the
    chunk."""
    c = ops.BITSET_ARC_CHUNK
    n = 5000
    hub = Graph(n, np.concatenate([rng.integers(0, n, 120_000), rng.integers(0, n, 20_000)]),
                np.concatenate([np.zeros(120_000, np.int64), rng.integers(1, n - 100, 20_000)]),
                np.zeros(n, np.int32))
    m_rest = 77
    boundary = Graph(300, rng.integers(0, 300, 2 * c + m_rest),
                     np.concatenate([np.zeros(c, np.int64), np.ones(c, np.int64),
                                     rng.integers(2, 250, m_rest)]),
                     np.zeros(300, np.int32))
    return {"hub": hub, "chunk boundary": boundary}


def wave_cands(rng, kind, hops, n, hub):
    """int32[hops, n] candidacy words of one phase-2a wave case."""
    if kind == "random words":
        # every bit pattern, a third of the words 0, the hub's nonzero
        words = rng.integers(-2**31, 2**31, size=(hops, n), dtype=np.int64)
        words[rng.random((hops, n)) < 1 / 3] = 0
        words[:, hub] = np.where(words[:, hub] == 0, 1, words[:, hub])
        return torch.from_numpy(words.astype(np.int32))
    if kind == "every vertex":
        return torch.full((hops, n), -1, dtype=torch.int32)
    cand = np.where(rng.random((hops, n)) < 0.5, -1, 0).astype(np.int32)
    if kind == "hub live every hop":
        cand[:, hub] = -1
    elif kind == "hub live in alternate hops":
        cand[:, hub] = np.where(np.arange(hops) % 2 == 0, -1, 0)
    elif kind == "empty hop":
        cand[min(1, hops - 1)] = 0  # hop 1 (hop 0 at L = 1) has no candidate
    return torch.from_numpy(cand)


def poison_allocator(shapes, rng, dev):
    """Fill and free tensors of the shapes the wave wrapper allocates, so that
    its torch.empty buffers hold random words, not zeros."""
    for shape in shapes:
        t = torch.from_numpy(rng.integers(-2**31, 2**31, size=shape,
                                          dtype=np.int64).astype(np.int32)).to(dev)
        del t


def wave_checks(rng, dge, hub):
    """bitset_wave against its plain version on the hub graph, W in
    {1, 2, 4, 32, 48} x L in {1, 3, 6}: the hub (in-degree 120,000, split
    over hundreds of work items) live in every hop and in alternate hops
    (live in hops r - 1 and r + 1, not in r), random candidacy words, a hop
    without candidates, every vertex a candidate; two calls back to back on
    different inputs, the second's scratch holding the first's rows; and one
    call under torch.cuda.set_sync_debug_mode("error"), which raises on any
    host sync. Every call's buffers come from a poisoned allocator. Returns
    the number of checks."""
    dev = DEVICE
    kinds = ("hub live every hop", "hub live in alternate hops", "random words",
             "empty hop", "every vertex")
    n_checks = 0
    for w in (1, 2, 4, 32, 48):
        for hops in (1, 3, 6):
            ea = torch.from_numpy(rng.random(dge.m) < 0.6).to(dev)
            cap = ops.wave_item_capacity(dge.n, dge.m)
            shapes = [(max(1, min(ops.BITSET_WAVE_BUFFERS, hops - 1)), dge.n, w),
                      (hops, cap, 2), (dge.n, w)]

            def run(vals, cand, label):
                want = ref.bitset_wave_ref(vals, dge.src, dge.dst, dge.n, ea, cand)
                poison_allocator(shapes, rng, dev)
                got = ops.bitset_wave(vals, dge, ea, cand)
                sync()
                check(torch.equal(got, want),
                      f"bitset_wave W={w} L={hops}, {label}, differs")

            for kind in kinds:
                run(random_words(rng, dge.n, w, dev),
                    wave_cands(rng, kind, hops, dge.n, hub).to(dev), kind)
                n_checks += 1
            # back to back: no sync between the calls
            ins = [(random_words(rng, dge.n, w, dev),
                    wave_cands(rng, "hub live in alternate hops", hops, dge.n,
                               hub).to(dev)) for _ in range(2)]
            wants = [ref.bitset_wave_ref(v, dge.src, dge.dst, dge.n, ea, c)
                     for v, c in ins]
            poison_allocator(shapes, rng, dev)
            gots = [ops.bitset_wave(v, dge, ea, c) for v, c in ins]
            sync()
            check(all(torch.equal(g, x) for g, x in zip(gots, wants)),
                  f"bitset_wave W={w} L={hops}, two calls back to back, differs")
            n_checks += 1
            # no host sync inside the wrapper
            vals = random_words(rng, dge.n, w, dev)
            cand = wave_cands(rng, "hub live every hop", hops, dge.n, hub).to(dev)
            want = ref.bitset_wave_ref(vals, dge.src, dge.dst, dge.n, ea, cand)
            sync()
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = ops.bitset_wave(vals, dge, ea, cand)
            finally:
                if dev == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            sync()
            check(torch.equal(got, want),
                  f"bitset_wave W={w} L={hops} under sync debug mode differs")
            n_checks += 1
    return n_checks


def phase_kernels_small():
    """Bit-exact kernel-vs-plain checks on the card at small shapes."""
    log("== phase 2a: kernels vs plain versions (bit-exact)")
    g0 = gen.rmat_graph(12, edge_factor=8, seed=SEED)
    # 100 extra vertices with no arcs at all
    g = Graph(g0.n + 100, g0.src, g0.dst,
              np.concatenate([g0.labels, np.zeros(100, np.int32)]))
    dev = DEVICE
    dg = DeviceGraph.from_host(g, dev)
    rng = np.random.default_rng(SEED)
    n_checks = 0
    some = torch.from_numpy(rng.random(dg.m) < 0.6).to(dev)
    none = torch.zeros(dg.m, dtype=torch.bool, device=dev)
    for w in (1, 2, 4, 32):
        vals = random_words(rng, dg.n, w, dev)
        check(bool((vals < 0).any()), "test words must set bit 31")
        for ea in (some, none):
            got = ops.bitset_or_aggregate(vals, dg, ea)
            want = ref.bitset_spmm_ref(vals, dg.src, dg.dst, dg.n, ea)
            sync()
            check(torch.equal(got, want), f"bitset_spmm W={w} differs")
            n_checks += 1
        for hops in (0, 1, 3, 6):
            cand_np = np.where(rng.random((hops, dg.n)) < 0.8, -1, 0).astype(np.int32)
            cand = torch.from_numpy(cand_np).to(dev)
            for ea in (some, none):
                got = ops.bitset_wave(vals, dg, ea, cand)
                want = ref.bitset_wave_ref(vals, dg.src, dg.dst, dg.n, ea, cand)
                sync()
                check(torch.equal(got, want),
                      f"bitset_wave W={w} L={hops} differs")
                n_checks += 1
    for w in (1, 2):
        check(not ops.bitset_or_aggregate(
            random_words(rng, dg.n, w, dev), dg, some)[-100:].any(),
            f"vertices without in-arcs must aggregate to 0 (W={w})")
        n_checks += 1
    graphs = spmm_edge_graphs(rng)
    for name, ge in graphs.items():
        dge = DeviceGraph.from_host(ge, dev)
        in_deg = dge.dst_ptr[1:] - dge.dst_ptr[:-1]
        for w in (1, 2):
            vals = random_words(rng, dge.n, w, dev)
            for label, ea in (("some", torch.from_numpy(rng.random(dge.m) < 0.6).to(dev)),
                              ("none", torch.zeros(dge.m, dtype=torch.bool, device=dev))):
                got = ops.bitset_or_aggregate(vals, dge, ea)
                want = ref.bitset_spmm_ref(vals, dge.src, dge.dst, dge.n, ea)
                sync()
                check(torch.equal(got, want),
                      f"bitset_spmm W={w} on the {name} graph, {label} active, differs")
                n_checks += 1
        log(f"  {name} graph: n={dge.n} m={dge.m} (m mod {ops.BITSET_ARC_CHUNK} = "
            f"{dge.m % ops.BITSET_ARC_CHUNK}), max in-degree {int(in_deg.max())}, "
            f"{int((in_deg == 0).sum())} vertices without in-arcs")
    n_wave = wave_checks(rng, DeviceGraph.from_host(graphs["hub"], dev), 0)
    log(f"{n_checks + n_wave} kernel/plain comparisons bit-exact "
        f"(n={dg.n}, m={dg.m}, W in 1/2/4/32, L in 0/1/3/6; the hub and "
        f"chunk-boundary graphs at W in 1/2; {n_wave} bitset_wave cases on the "
        f"hub graph, W in 1/2/4/32/48, L in 1/3/6, one call of each under sync "
        f"debug mode)")


def spmm_moved_bytes(dg, edge_active, w):
    """(device-memory bytes, L2 bytes) that the edge-balanced bitset_spmm
    moves at W <= 2: dst and the active flag of every arc, src of every
    active arc, the output zeroed and written once; and the vals word rows
    gathered per active arc, which the L2 serves after their first touch."""
    active = int(edge_active.sum())
    return dg.m * 5 + active * 4 + 2 * dg.n * 4 * w, active * 4 * w


def phase_kernel_timing(dg, template, label_freq):
    """Kernel, plain and bound times at the scale-20 main-path shapes."""
    log(f"== phase 2b: kernel times at the scale-20 main-path shapes ({CARD})")
    state0 = init_state(dg, template)
    # LCC sweep input: omega packed to W = 1 word, every arc active
    vals = pack_bits(state0.omega)
    ea0 = state0.edge_active
    out_k = ops.bitset_or_aggregate(vals, dg, ea0)
    out_p = ref.bitset_spmm_ref(vals, dg.src, dg.dst, dg.n, ea0)
    spmm = {
        "max_abs_err": max_abs_err(out_k, out_p),
        "ms": time_ms(lambda: ops.bitset_or_aggregate(vals, dg, ea0), 20),
        "device_ms": kernel_device_ms(
            lambda: ops.bitset_or_aggregate(vals, dg, ea0), 20, "bitset_spmm"),
        "plain_ms": time_ms(
            lambda: ref.bitset_spmm_ref(vals, dg.src, dg.dst, dg.n, ea0), 2),
    }
    spmm["bound_ms"], spmm["bound_by"] = bound(spmm_cost(dg, ea0, vals.shape[1]))
    check(spmm["max_abs_err"] == 0, "bitset_spmm differs at scale 20")
    moved, gathered = spmm_moved_bytes(dg, ea0, vals.shape[1])
    log(f"bitset_spmm  W={vals.shape[1]} n={dg.n} m={dg.m}: "
        f"{spmm['ms']:.4f} ms kernel ({spmm['device_ms']:.4f} ms on the device, "
        f"{spmm['device_ms'] / spmm['bound_ms']:.2f}x bound), "
        f"{spmm['plain_ms']:.4f} ms plain, "
        f"{spmm['bound_ms']:.4f} ms bound ({spmm['bound_by']}); the kernel moves "
        f"{moved / 1e6:.1f} MB of device memory ({moved / spmm['device_ms'] / 1e9:.2f} "
        f"TB/s) and gathers {gathered / 1e6:.1f} MB of vals rows")

    # NLCC wave input: the first wave after the initial LCC fixpoint
    state1 = lcc_fixpoint(dg, TemplateDev(template, dg.device), state0,
                          route=registry.ROUTE_PACKED)
    packed, cand = first_wave_inputs(dg, template, state1, label_freq)
    ea1 = state1.edge_active
    wave = wave_timing(dg, packed, ea1, cand, "main-path wave")
    # the same wave with every vertex a candidate in every hop
    wave["every_vertex"] = wave_timing(dg, packed, ea1, torch.full_like(cand, -1),
                                       "every vertex a candidate")
    return {"bitset_spmm": spmm, "bitset_wave": wave}


def wave_timing(dg, packed, ea, cand, label):
    """bitset_wave's times, the plain version's and the bound on one wave's
    inputs, checked bit-exact, with each hop's candidates and the largest
    in-degree of a candidate."""
    hops = cand.shape[0]
    out_k = ops.bitset_wave(packed, dg, ea, cand)
    out_p = ref.bitset_wave_ref(packed, dg.src, dg.dst, dg.n, ea, cand)
    t = {
        "max_abs_err": max_abs_err(out_k, out_p),
        "ms": time_ms(lambda: ops.bitset_wave(packed, dg, ea, cand), 20),
        "device_ms": kernel_device_ms(
            lambda: ops.bitset_wave(packed, dg, ea, cand), 20, "bitset_wave",
            per_call=1 + hops),
        "plain_ms": time_ms(lambda: ref.bitset_wave_ref(
            packed, dg.src, dg.dst, dg.n, ea, cand), 2),
    }
    del out_k, out_p
    t["bound_ms"], t["bound_by"] = bound(wave_cost(dg, ea, cand, packed.shape[1]))
    check(t["max_abs_err"] == 0, f"bitset_wave differs at scale 20 ({label})")
    live = cand != 0
    deg = dg.dst_ptr[1:] - dg.dst_ptr[:-1]
    t["candidates_per_hop"] = [int(live[r].sum()) for r in range(hops)]
    t["max_candidate_in_degree"] = int(deg[live.any(0)].max()) if live.any() else 0
    log(f"bitset_wave  W={packed.shape[1]} L={hops} ({label}) active arcs="
        f"{int(ea.sum())} candidates per hop={t['candidates_per_hop']}, largest "
        f"in-degree of a candidate {t['max_candidate_in_degree']}: "
        f"{t['ms']:.4f} ms kernel ({t['device_ms']:.4f} ms on the device, "
        f"{t['device_ms'] / t['bound_ms']:.2f}x bound), "
        f"{t['plain_ms']:.4f} ms plain, "
        f"{t['bound_ms']:.4f} ms bound ({t['bound_by']})")
    return t


def phase_parity():
    """Scale-14 prune + count: card (kernels) against CPU (plain versions),
    and the three NLCC routes on the card."""
    log(f"== phase 3: R-MAT scale {SCALE_PARITY}, card vs CPU")
    g = gen.rmat_graph(SCALE_PARITY, edge_factor=EDGE_FACTOR, seed=SEED)
    tmpl = Template(*HEX)
    runs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        res = prune(g, tmpl, device=dev)
        cnt = count_matches(res)
        runs[dev] = (res, cnt)
        log(f"{dev}: {time.perf_counter() - t0:.2f} s, {res.counts()}, "
            f"matches {cnt.n_embeddings}, routes {res.stats['dispatch_routes']}, "
            f"lcc_iterations {res.stats['lcc_iterations']}")
    (rc, cc), (rp, cp) = runs[DEVICE], runs["cpu"]
    check(np.array_equal(rc.omega, rp.omega), "omega differs card vs CPU")
    check(np.array_equal(rc.edge_mask, rp.edge_mask), "edge mask differs")
    check(trajectory(rc) == trajectory(rp), "phase trajectory differs")
    check(rc.stats["lcc_iterations"] == rp.stats["lcc_iterations"],
          "lcc_iterations differ")
    check(cc.n_embeddings == cp.n_embeddings, "match count differs")
    check(rc.stats.get("dispatch_routes") == {"prune.lcc": "packed",
                                              "prune.nlcc": "fused"},
          "the default routes must be the kernels' routes")
    for route in ("packed", "unpacked"):
        r2 = prune(g, tmpl, device=DEVICE, nlcc_route=route)
        check(np.array_equal(r2.omega, rc.omega)
              and np.array_equal(r2.edge_mask, rc.edge_mask),
              f"NLCC route {route} differs from fused on the card")
    sync()
    log(f"card == CPU: omega, edge mask, {len(rc.phases)}-phase trajectory, "
        f"lcc_iterations, match count; NLCC fused == packed == unpacked")
    return g


def edge_trajectory(res):
    return [(p.phase, p.active_vertices, p.active_edges, p.omega_bits,
             p.extra.get("nlcc_edges_pruned")) for p in res.phases]


def phase_parity_a2(g):
    """Scale 14, card against CPU: the edge-prune prune, the device join
    against the host join, and streaming against materializing."""
    log(f"== phase 3b: R-MAT scale {SCALE_PARITY}, edge-prune prune and the "
        f"device join, card vs CPU")
    tmpl = Template(*HEX)
    runs = {}
    for dev in (DEVICE, "cpu"):
        registry.reset_launches()
        t0 = time.perf_counter()
        res = prune(g, tmpl, device=dev, nlcc_edge_prune=True)
        sync()
        t_prune = time.perf_counter() - t0
        launches = registry.launch_counts()
        cnt = {r: count_matches(res, route=r) for r in ("host", "device")}
        emb = {r: enumerate_matches(res, route=r) for r in ("host", "device")}
        runs[dev] = (res, cnt, emb)
        log(f"{dev}: edge-prune prune {t_prune:.2f} s, {res.counts()}, "
            f"trajectory {edge_trajectory(res)}, skip complete TDS "
            f"{res.stats.get('tds_skipped_via_frontier_edge_prune')}, "
            f"matches {cnt['device'].n_embeddings} (device join) "
            f"{cnt['host'].n_embeddings} (host join), launches "
            f"{ {k: launches[k] for k in registry.PRUNE_KERNELS} }")
        if dev == "cuda":
            for name in registry.PRUNE_KERNELS:
                check(launches[name] > 0,
                      f"{name} never launched on the scale-14 edge-prune prune")
        for r in ("host", "device"):
            check(cnt[r].route == r and emb[r].route == r,
                  f"route {r} was not taken")
        check(cnt["host"].n_embeddings == cnt["device"].n_embeddings
              == emb["host"].n_embeddings, f"{dev}: join routes disagree")
        check(np.array_equal(emb["host"].embeddings, emb["device"].embeddings),
              f"{dev}: device join rows differ from the host join's")
        blocks = list(stream_matches(res, route="device", max_rows=64))
        rows = (np.unique(np.concatenate(blocks), axis=0) if blocks
                else np.zeros((0, tmpl.n0), np.int32))
        check(np.array_equal(rows, emb["device"].embeddings)
              and sum(b.shape[0] for b in blocks) == emb["device"].n_embeddings,
              f"{dev}: the streamed union differs from the materialized set")
    (rc, cc, ec), (rp, cp, ep) = runs[DEVICE], runs["cpu"]
    check(np.array_equal(rc.omega, rp.omega), "edge prune: omega differs card vs CPU")
    check(np.array_equal(rc.edge_mask, rp.edge_mask),
          "edge prune: edge mask differs card vs CPU")
    check(edge_trajectory(rc) == edge_trajectory(rp),
          "edge prune: trajectory or nlcc_edges_pruned differs card vs CPU")
    check(rc.stats["lcc_iterations"] == rp.stats["lcc_iterations"],
          "edge prune: lcc_iterations differ card vs CPU")
    check(np.array_equal(ec["device"].embeddings, ep["host"].embeddings),
          "device join on the card differs from the CPU run")
    check(cc["device"].n_embeddings > 0, "no match at scale 14")
    log(f"card == CPU for the edge-prune prune (omega, edge mask, trajectory "
        f"with nlcc_edges_pruned, lcc_iterations); device join == host join "
        f"== CPU ({cc['device'].n_embeddings} matches, rows and counts); "
        f"streamed union == materialized")


def phase_join_many(g):
    """Scale 14, a repeated-label triangle with thousands of matches: the
    edge-prune prune card against CPU, the two joins in both modes on both
    devices, and streaming and the chunk back-off under a tight budget."""
    log(f"== phase 3c: R-MAT scale {SCALE_PARITY}, the joins at many rows "
        f"({CARD})")
    tmpl = Template(*TRI_MANY)
    runs = {}
    for dev in (DEVICE, "cpu"):
        res, t_prune = timed(
            lambda: prune(g, tmpl, device=dev, nlcc_edge_prune=True))
        out = {}
        for route in ("host", "device"):
            for mode in ("count", "materialize"):
                e, secs = timed(lambda: enumerate_matches(
                    res, mode=mode, route=route))
                check(e.route == route, f"{mode} took {e.route}, not {route}")
                out[route, mode] = (e, secs)
        want = out["host", "materialize"][0]
        for key, (e, _) in out.items():
            check(e.n_embeddings == want.n_embeddings,
                  f"{dev}: {key} counts {e.n_embeddings}, the host join "
                  f"materializes {want.n_embeddings}")
        check(np.array_equal(out["device", "materialize"][0].embeddings,
                             want.embeddings),
              f"{dev}: device join rows differ from the host join's")
        check(want.n_embeddings >= 1000,
              f"{dev}: only {want.n_embeddings} matches")
        log(f"{dev}: edge-prune prune {t_prune:.2f} s, {res.counts()}, "
            f"{want.n_embeddings} matches (|Aut|={want.automorphisms}); join "
            f"seconds " + ", ".join(
                f"{r} {m} {secs:.4f}" for (r, m), (_, secs) in out.items()))
        runs[dev] = (res, out)
    (rc, oc), (rp, op) = runs[DEVICE], runs["cpu"]
    check(np.array_equal(rc.omega, rp.omega)
          and np.array_equal(rc.edge_mask, rp.edge_mask)
          and edge_trajectory(rc) == edge_trajectory(rp)
          and rc.stats["lcc_iterations"] == rp.stats["lcc_iterations"],
          "many-row template: the edge-prune prune differs card vs CPU")
    full = oc["device", "materialize"][0]
    check(np.array_equal(full.embeddings,
                         op["host", "materialize"][0].embeddings),
          "many-row template: the device join on the card differs from the "
          "CPU's host join")
    # a budget that splits row blocks: one source chunk, many blocks
    n_src = int(rc.omega[:, 0].sum())
    blocks = list(stream_matches(rc, route="device", max_rows=JOIN_TIGHT_ROWS))
    check(len(blocks) > -(-n_src // 4096),
          f"{len(blocks)} streamed blocks over {n_src} sources: no split")
    check(np.array_equal(np.unique(np.concatenate(blocks), axis=0),
                         full.embeddings)
          and sum(b.shape[0] for b in blocks) == full.n_embeddings,
          "many-row template: the streamed union differs from the "
          "materialized set")
    # a chunk that backs off and sources that overflow at chunk 1
    tight = {}
    for mode in ("materialize", "count"):
        st = {}
        e = enumerate_matches(rc, mode=mode, route="device",
                              max_rows=JOIN_TIGHT_ROWS, chunk=JOIN_TIGHT_CHUNK,
                              stats=st)
        tight[mode] = st.get("enum_stream_fallbacks", 0)
        check(tight[mode] > 0, f"{mode}: no source overflowed at chunk 1")
        check(e.n_embeddings == full.n_embeddings,
              f"{mode} under the tight budget counts {e.n_embeddings}")
        if mode == "materialize":
            check(np.array_equal(e.embeddings, full.embeddings),
                  "the tight-budget rows differ from the materialized set")
    log(f"card == CPU for the edge-prune prune and the joins; device join == "
        f"host join ({full.n_embeddings} rows); max_rows={JOIN_TIGHT_ROWS}: "
        f"{len(blocks)} streamed blocks over {n_src} sources, union == "
        f"materialized; chunk {JOIN_TIGHT_CHUNK}: {tight} sources finished by "
        f"the streaming emitter, rows and counts equal")


def phase_full(g, dg):
    """The main path at full size, with launch counts read around it."""
    log(f"== phase 4: R-MAT scale {SCALE_FULL} main path on the card")
    tmpl = Template(*HEX)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    res = prune(dg, tmpl, label_freq=g.label_frequency())
    t_prune = time.perf_counter() - t0
    t1 = time.perf_counter()
    cnt = count_matches(res)
    sync()
    t_count = time.perf_counter() - t1
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    for p in res.phases:
        log(f"  {p.phase:11s} {str(p.constraint or ''):28s} {p.seconds:9.4f} s "
            f"V*={p.active_vertices:8d} E*={p.active_edges:9d} "
            f"waves={p.extra.get('nlcc_waves', '-')}")
    log(f"prune {t_prune:.3f} s, count {t_count:.3f} s; {res.counts()}, "
        f"matches {cnt.n_embeddings} (|Aut|={cnt.automorphisms}), "
        f"lcc_iterations {res.stats['lcc_iterations']}, "
        f"routes {res.stats['dispatch_routes']}")
    log(f"max_memory_allocated {peak / 2**30:.3f} GiB; launches {launches}")
    for name in registry.PRUNE_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(sum(registry.plain_counts().values()) == 0,
          "the main path ran a plain version on the card")
    check(cnt.n_embeddings > 0, "the scale-20 main path found no match")
    # device time by kernel and the device's busy share over one more prune
    profile_device(lambda: prune(dg, tmpl, label_freq=g.label_frequency()), 1,
                   "prune", "bitset_spmm")

    r2 = prune(dg, Template(*RMAT2), label_freq=g.label_frequency())
    log(f"RMAT-2 on the same graph: after the first LCC V*="
        f"{r2.phases[0].active_vertices} E*={r2.phases[0].active_edges}; "
        f"final {r2.counts()}")

    # quickstart: planted diamond needles in a random-label R-MAT background
    background = gen.rmat_graph(12, edge_factor=8, seed=0, labeler="random",
                                n_labels=8)
    needle = Graph.from_undirected_pairs(
        4, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)], [9, 8, 9, 8])
    gq = gen.planted_pattern_graph(background, needle, n_copies=5, seed=1)
    tq = Template([9, 8, 9, 8], [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)])
    rq = prune(gq, tq, device=DEVICE)
    eq = enumerate_matches(rq)
    log(f"quickstart: {rq.counts()}, {eq.n_embeddings} embeddings, "
        f"|Aut|={eq.automorphisms}")
    check(eq.n_embeddings >= 5 * eq.automorphisms, "planted needles missing")
    return launches, res, cnt


def phase_edge_prune_full(g, dg, default, default_count):
    """Scale 20, "hex-unique", with the frontier edge-prune pass: seconds by
    phase, peak memory, launches, and the count by both joins, beside the
    default prune of phase 4."""
    log(f"== phase 4b: R-MAT scale {SCALE_FULL} edge-prune prune on the card "
        f"({CARD})")
    tmpl = Template(*HEX)
    sync()
    reset_peak()
    registry.reset_launches()
    t0 = time.perf_counter()
    res = prune(dg, tmpl, label_freq=g.label_frequency(), nlcc_edge_prune=True)
    t_prune = time.perf_counter() - t0
    launches = registry.launch_counts()
    peak = peak_gib()
    for p in res.phases:
        log(f"  {p.phase:11s} {str(p.constraint or ''):28s} {p.seconds:9.4f} s "
            f"V*={p.active_vertices:8d} E*={p.active_edges:9d} "
            f"waves={p.extra.get('nlcc_waves', '-')} "
            f"edges pruned={p.extra.get('nlcc_edges_pruned', '-')}")
    skipped = res.stats.get("tds_skipped_via_frontier_edge_prune")
    diff = {"vertices": int((res.vertex_mask != default.vertex_mask).sum()),
            "arcs": int((res.edge_mask != default.edge_mask).sum()),
            "omega bits": int((res.omega != default.omega).sum())}
    log(f"edge-prune prune {t_prune:.3f} s, peak {peak:.3f} GiB, "
        f"{res.counts()} (default prune {default.counts()}; differences "
        f"{diff}), tds_skipped_via_frontier_edge_prune {skipped}, "
        f"lcc_iterations {res.stats['lcc_iterations']}, routes "
        f"{res.stats['dispatch_routes']}, "
        f"launches { {k: launches[k] for k in registry.PRUNE_KERNELS} }")
    for name in registry.PRUNE_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the edge-prune prune")
    # the fast path claims the exact result for this unique-label cycle, and
    # the default prune (complete-walk TDS) guarantees it: the two agree, and
    # keep exactly the vertices, arcs and candidacies the matches use
    check(not any(diff.values()),
          f"the edge-prune prune differs from the default prune's: {diff}")
    check_keeps_the_matches(res, tmpl)
    # device time by kernel and the busy share over one more such prune
    def prune_again():
        return prune(dg, tmpl, label_freq=g.label_frequency(),
                     nlcc_edge_prune=True)

    profile_device(prune_again, 1, "edge-prune prune", "bitset_spmm")
    # every bitset_wave call of one more such prune against the plain version
    with waves_held_to_plain(dg) as calls:
        again = prune_again()
    check(np.array_equal(again.omega, res.omega)
          and np.array_equal(again.edge_mask, res.edge_mask),
          "a second edge-prune prune differs from the first")
    summary = {}
    for graph, w, hops, in_deg, err in calls:
        key = (graph, w, hops)
        n_calls, top, worst = summary.get(key, (0, 0, 0))
        summary[key] = (n_calls + 1, max(top, in_deg), max(worst, err))
    log("bitset_wave calls of the edge-prune prune, by (graph, W, L): "
        + "; ".join(f"{k}: {c} calls, largest candidate in-degree {d}, "
                    f"max_abs_err {e}" for k, (c, d, e) in sorted(summary.items())))
    check(all(c[4] == 0 for c in calls),
          "bitset_wave differs from its plain version on the edge-prune prune")
    check(any(k[0] == "reversed" for k in summary)
          and any(k[0] == "graph" and k[2] == 1 for k in summary),
          "the pass's one-hop calls over the graph and its reverse were not "
          "all checked")
    counts = {}
    for route in ("device", "host"):
        sync()
        t1 = time.perf_counter()
        c = count_matches(res, route=route)
        sync()
        counts[route] = (c.n_embeddings, time.perf_counter() - t1)
        check(c.route == route, f"count took {c.route}, not {route}")
    log(f"count: device join {counts['device'][0]} matches in "
        f"{counts['device'][1]:.4f} s, host join {counts['host'][0]} in "
        f"{counts['host'][1]:.4f} s ({CARD})")
    check(counts["device"][0] == counts["host"][0] == default_count,
          "the edge-prune prune's count differs from the default prune's")
    return {"seconds": t_prune, "peak_gib": peak, "counts": res.counts(),
            "default_counts": default.counts(), "skipped_tds": skipped,
            "launches": {k: launches[k] for k in registry.PRUNE_KERNELS},
            "count_device_s": counts["device"][1],
            "count_host_s": counts["host"][1]}


@contextlib.contextmanager
def waves_held_to_plain(dg):
    """Within the block, every `ops.bitset_wave` call (the kernel on the
    card) is also computed by `ref.bitset_wave_ref` on the same inputs;
    yields the list of (graph: "graph" for `dg`, else "reversed"; W; L; the
    largest in-degree of a candidate; max_abs_err) per call."""
    calls = []
    kernel = ops.bitset_wave

    def checked(vals, graph, edge_active, cand):
        out = kernel(vals, graph, edge_active, cand)
        want = ref.bitset_wave_ref(vals, graph.src, graph.dst, graph.n,
                                   edge_active, cand)
        deg = graph.dst_ptr[1:] - graph.dst_ptr[:-1]
        live = (cand != 0).any(0)
        calls.append(("graph" if graph is dg else "reversed", vals.shape[1],
                      cand.shape[0], int(deg[live].max()) if live.any() else 0,
                      max_abs_err(out, want)))
        return out

    ops.bitset_wave = checked
    try:
        yield calls
    finally:
        ops.bitset_wave = kernel


def check_keeps_the_matches(res, tmpl):
    """The prune kept exactly the vertices, arcs and omega bits that some
    match uses (what an exact prune keeps)."""
    rows = enumerate_matches(res).embeddings.astype(np.int64)
    n = res.omega.shape[0]
    omega = np.zeros_like(res.omega)
    for q in range(tmpl.n0):
        omega[rows[:, q], q] = True
    used = np.unique(np.concatenate(
        [rows[:, a] * n + rows[:, b]
         for a in range(tmpl.n0) for b in tmpl.adj[a]]))
    keys = res.dg.src.long().cpu().numpy() * n + res.dg.dst.long().cpu().numpy()
    arcs = np.isin(keys, used)
    check(np.array_equal(omega, res.omega) and np.array_equal(arcs, res.edge_mask)
          and np.array_equal(omega.any(1), res.vertex_mask),
          f"the prune keeps more or less than its {rows.shape[0]} matches use: "
          f"{int((omega != res.omega).sum())} omega bits, "
          f"{int((arcs != res.edge_mask).sum())} arcs differ")


def same_result(res, default, default_count, what):
    check(np.array_equal(res.omega, default.omega), f"{what}: omega differs")
    check(np.array_equal(res.edge_mask, default.edge_mask),
          f"{what}: edge mask differs")
    check(count_matches(res).n_embeddings == default_count,
          f"{what}: match count differs")


def phase_planner_policy(g, dg, default, default_count):
    """Scale 20: graph statistics and the planner's seconds; the LCC, NLCC
    and join routes tuned on the card (cache in a temporary directory); the
    prune under the tuned policy and under a recorded plan, each equal to
    the untuned prune."""
    log(f"== phase 4c: R-MAT scale {SCALE_FULL} planner and tuned policy "
        f"({CARD})")
    tmpl = Template(*HEX)
    backend = dg.device.type
    sync()
    t0 = time.perf_counter()
    stats = collect_graph_stats(dg, n_labels=g.n_labels)
    t_stats = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = planner.plan_query(tmpl, stats, backend=backend, wave=WAVE)
    t_plan = time.perf_counter() - t0
    host_stats = collect_graph_stats(g)
    check(np.array_equal(stats.label_hist, host_stats.label_hist)
          and np.array_equal(stats.degree_hist, host_stats.degree_hist),
          "device graph stats differ from the host's")
    log(f"collect_graph_stats(dg) {t_stats:.4f} s (bucket {stats.bucket()}); "
        f"plan_query {t_plan:.4f} s: {plan.source}, "
        f"{[(p.signature, p.engine, p.direction) for p in plan.phases]}, "
        f"predicted {plan.predicted_s:.6g} s")

    # candidates of one LCC sweep, one NLCC wave and the join per mode, as
    # the JAX package's dispatch-policy benchmark times them. The unpacked
    # wave is no candidate here: its [m, wave] message plane alone would be
    # 32 GB of bools at this size.
    state0 = init_state(dg, tmpl)
    tdev = TemplateDev(tmpl, dg.device)
    state1 = lcc_fixpoint(dg, tdev, state0, route=registry.ROUTE_PACKED)
    c = next(c for c in generate_constraints(tmpl, label_freq=g.label_frequency())
             if c.kind == "cycle")
    walk = nlcc.expand_walks(c)[0]
    cand = torch.stack([state1.omega[:, q] for q in walk], dim=0)
    sources = np.flatnonzero(state1.omega[:, walk[0]].cpu().numpy())
    ids, _ = next(nlcc.wave_batches(sources, WAVE))
    ids = torch.from_numpy(ids.astype(np.int64)).to(dg.device)
    routes = [
        (lcc.LCC_ROUTE, lcc.lcc_route_bucket(dg), {
            registry.ROUTE_PACKED: lambda: lcc.lcc_iteration_packed(
                dg, tdev, state0),
            registry.ROUTE_UNPACKED: lambda: lcc.lcc_iteration(dg, tdev, state0),
        }),
        (nlcc.NLCC_ROUTE, nlcc.nlcc_route_bucket(dg.n, WAVE), {
            r: (lambda fused=(r == registry.ROUTE_FUSED):
                nlcc.check_walk_constraint_packed(dg, state1, cand, True, ids,
                                                  fused=fused))
            for r in (registry.ROUTE_FUSED, registry.ROUTE_PACKED)}),
    ]
    registry.set_policy(None)
    for mode in ("count", "materialize"):
        routes.append((ENUM_ROUTE, ("local", mode), {
            r: (lambda m=mode, r=r: enumerate_matches(default, mode=m, route=r))
            for r in (registry.ROUTE_HOST, registry.ROUTE_DEVICE)}))
    os.makedirs(ROOT / "experiments", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "experiments") as tmp:
        path = os.path.join(tmp, "torch_dispatch_policy.json")
        t0 = time.perf_counter()
        pol = registry.tune(routes=routes, backend=backend, repeat=3, path=path)
        t_tune = time.perf_counter() - t0
        check(registry.DispatchPolicy.load(path).to_json() == pol.to_json(),
              "the tuned cache does not read back")
    tuned = {}
    for key, entry in sorted(pol.routes.items()):
        tuned[key] = {"choice": entry.choice, "measured_s": entry.measured_s}
        log(f"  tuned {key}: {entry.choice}; measured "
            f"{ {k: round(v, 6) for k, v in entry.measured_s.items()} } s")
    log(f"tune {t_tune:.2f} s ({CARD})")

    out = {"stats_s": t_stats, "plan_s": t_plan, "plan_source": plan.source,
           "plan": [(p.signature, p.engine, p.direction) for p in plan.phases],
           "tuned": tuned}
    # the prune under the tuned policy (the routes it names), then under the
    # recorded plan; each equals the untuned prune
    for label in ("tuned", "planned"):
        if label == "planned":
            pol = registry.DispatchPolicy()
            planner.record_plan(pol, tmpl, host_stats, plan, backend=backend)
        registry.set_policy(pol)
        registry.reset_launches()
        t0 = time.perf_counter()
        res = prune(dg, tmpl, label_freq=g.label_frequency())
        sync()
        secs = time.perf_counter() - t0
        launches = {k: registry.launch_counts()[k] for k in registry.PRUNE_KERNELS}
        registry.set_policy(None)
        same_result(res, default, default_count, f"the {label} prune")
        log(f"{label} prune {secs:.3f} s: routes {res.stats['dispatch_routes']}, "
            f"plan {res.stats['plan']['source']} "
            f"{[(p['sig'], p['direction']) for p in res.stats['plan']['phases']]}, "
            f"launches {launches}; omega, edge mask and count equal the untuned "
            f"prune's")
        if label == "planned":
            check(res.stats["plan"]["source"] == "policy",
                  "the recorded plan was not used")
        out[label] = {"seconds": secs, "routes": res.stats["dispatch_routes"],
                      "launches": launches}
    return out


def phase_quickstart_cli():
    """`python -m repro_torch.launch.quickstart` on the card, in a process of
    its own."""
    log("== phase 4d: python -m repro_torch.launch.quickstart")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.quickstart"]
    if DEVICE == "cpu":  # a rehearsal on the CPU
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    log(proc.stdout.strip())
    check(proc.returncode == 0 and proc.stdout.strip().endswith("OK"),
          f"the quickstart failed ({proc.returncode}): {proc.stderr[-2000:]}")
    check(f"on {DEVICE}" in proc.stdout, f"the quickstart did not run on {DEVICE}")
    log(f"quickstart exited 0 in {time.perf_counter() - t0:.1f} s")

# ------------------------------------------------- phase 8: many queries
def lane_arrays(res):
    """(omega, arc mask) of one prune result or batched lane, on the host."""
    return res.state.omega.cpu().numpy(), res.state.edge_active.cpu().numpy()


def same_lane(a, b):
    (oa, ea), (ob, eb) = a, b
    return np.array_equal(oa, ob) and np.array_equal(ea, eb)


def batch_counters(stats):
    return {k: stats.get(k) for k in BATCH_COUNTERS}


def phase_batch_parity(g):
    """Scale 14, card against CPU: `prune_batch` of the batch of
    tests/test_batch.py (labels moved to this graph's), a straggler pair at
    wave 32 and a deadline that passes in the middle of the run, each lane
    equal on both devices and to the single prune of its template; the
    serving engine in count and stream mode; the incremental session and
    the exploratory search of examples/interactive_search.py."""
    log(f"== phase 8a: R-MAT scale {SCALE_PARITY}, template-batched prune, "
        f"card vs CPU ({CARD})")
    batch = [Template([lab + BATCH_LABEL_SHIFT for lab in labels], edges)
             for labels, edges in BATCH_VARIANTS]
    stragglers = [Template(*s) for s in BATCH_STRAGGLERS]
    singles = {}

    def single(t, **kw):
        key = (repr(t), t.edge_set, tuple(sorted(kw.items())))
        if key not in singles:
            res = prune(g, t, device=DEVICE, **kw)
            singles[key] = (lane_arrays(res), count_matches(res).n_embeddings,
                            res)
        return singles[key]

    def ticking():
        tick = {"t": 0.0}

        def clock():
            tick["t"] += 1.0
            return tick["t"]
        return clock

    cases = {
        "batch": (batch, {}),
        "stragglers": (stragglers, {"wave": 32, "guarantee_precision": False}),
        # lane 0 (a path) is cancelled after the first LCC; lane 1 (a
        # square) goes on to its cycle waves
        "deadline": ([batch[1], batch[0]], {"deadlines": [1.5, None]}),
    }
    runs = {}
    for dev in (DEVICE, "cpu"):
        for name, (tmpls, kw) in cases.items():
            if name == "deadline":
                kw = dict(kw, clock=ticking())
            registry.reset_launches()
            bres, secs = timed(lambda: prune_batch(g, tmpls, device=dev, **kw))
            launches = {k: registry.launch_counts()[k]
                        for k in registry.PRUNE_KERNELS}
            counts = [count_matches(r).n_embeddings if s == "ok" else None
                      for r, s in zip(bres.results, bres.status)]
            runs[dev, name] = ([lane_arrays(r) for r in bres.results], counts,
                               bres.status, batch_counters(bres.stats))
            log(f"{dev} {name}: B={len(tmpls)} {secs:.3f} s, status "
                f"{bres.status}, counts {counts}, "
                f"{batch_counters(bres.stats)}, routes "
                f"{bres.stats['dispatch_routes']}, launches {launches}")
            if dev == "cuda":
                for k in registry.PRUNE_KERNELS:
                    check(launches[k] > 0,
                          f"{k} never launched on the scale-14 batch {name}")
    for name, (tmpls, kw) in cases.items():
        lanes, counts, status, counters = runs[DEVICE, name]
        check(runs["cpu", name][2] == status and runs["cpu", name][3] == counters,
              f"{name}: statuses or counters differ card vs CPU")
        check(runs["cpu", name][1] == counts, f"{name}: counts differ card vs CPU")
        for i, t in enumerate(tmpls):
            check(same_lane(lanes[i], runs["cpu", name][0][i]),
                  f"{name} lane {i}: omega or edge mask differs card vs CPU")
            if status[i] != "ok":
                check(not lanes[i][0].any() and not lanes[i][1].any(),
                      f"{name} lane {i}: a cancelled lane is not empty")
                continue
            skw = {k: v for k, v in kw.items()
                   if k in ("wave", "guarantee_precision")}
            want, want_count, _ = single(t, **skw)
            check(same_lane(lanes[i], want) and counts[i] == want_count,
                  f"{name} lane {i}: differs from the single prune")
    check(runs[DEVICE, "stragglers"][3]["nlcc_lockstep_padded"] > 0,
          "no straggler rode pad waves")
    check(runs[DEVICE, "deadline"][2] == ["deadline_missed", "ok"],
          "the mid-run deadline did not cancel lane 0 alone")
    log(f"card == CPU == single prunes: {len(batch)} lanes, "
        f"{sum(1 for c in runs[DEVICE, 'batch'][1] if c)} with matches "
        f"({sum(runs[DEVICE, 'batch'][1])} in all); stragglers; mid-run "
        f"deadline")

    # the serving engine on the card: count mode, then one stream query
    eng = GraphQueryEngine(g, max_batch=len(batch), device=DEVICE)
    ids = [eng.submit(t, mode=MODE_COUNT) for t in batch]
    sid = eng.submit(batch[1], mode=MODE_STREAM)
    results = {r.query_id: r for r in eng.drain()}
    check([results[q].n_embeddings for q in ids]
          == [single(t)[1] for t in batch], "count mode differs from the "
          "single prunes' counts")
    blocks = list(eng.stream(sid, chunk=1024))
    rows = (np.unique(np.concatenate(blocks), axis=0) if blocks
            else np.zeros((0, batch[1].n0), np.int32))
    want = enumerate_matches(single(batch[1])[2]).embeddings
    check(np.array_equal(rows, want) and rows.shape[0] > 0,
          "stream mode's rows differ from enumerate_matches")
    log(f"GraphQueryEngine on {eng.dg.device}: {eng.stats['n_batches']} "
        f"batches {[b['B'] for b in eng.stats['batches']]}; count mode == "
        f"single prunes; stream mode {rows.shape[0]} rows == enumerate_matches")

    # incremental and exploratory search, card against CPU
    gi = gen.rmat_graph(11, edge_factor=8, seed=0)
    gx = interactive_search.planted_squares()
    out = {}
    for dev in (DEVICE, "cpu"):
        session = IncrementalSession(
            gi, Template(interactive_search.LABELS,
                         interactive_search.REVISIONS[0]), device=dev)
        searches = []
        for edges in interactive_search.REVISIONS:
            state, stat = session.search(
                Template(interactive_search.LABELS, edges))
            searches.append((state.omega.cpu().numpy(), stat.matched_vertices,
                             stat.constraints_checked, stat.constraints_reused))
        ex = exploratory_search(gx, Template(*interactive_search.CLIQUE),
                                device=dev)
        out[dev] = (searches, ex)
        log(f"{dev}: incremental {[s[1:] for s in searches]}; exploratory "
            f"found at k={ex.found_level}, levels "
            f"{[(lv.k, lv.n_variants, lv.matched_vertices) for lv in ex.levels]}")
    (sc, xc), (sp, xp) = out[DEVICE], out["cpu"]
    check(all(np.array_equal(a[0], b[0]) and a[1:] == b[1:]
              for a, b in zip(sc, sp)),
          "incremental search differs card vs CPU")
    check(xc.found_level == xp.found_level
          and np.array_equal(xc.vertex_mask, xp.vertex_mask)
          and [(lv.k, lv.n_variants, lv.matched_vertices) for lv in xc.levels]
          == [(lv.k, lv.n_variants, lv.matched_vertices) for lv in xp.levels],
          "exploratory search differs card vs CPU")
    check(xc.found_level == 2, "the planted squares were not found at k = 2")
    log("card == CPU: incremental search (omega and QueryStat counts per "
        "revision), exploratory search (levels, found_level, vertex_mask)")


def phase_batch_full(g, dg):
    """Scale 20: `GraphQueryEngine` serves `example_workload(32)` in prune
    mode in batches of 8, without the complete-walk TDS (SERVE_PRECISION);
    each lane equals the single prune of its template on the card; q/s,
    seconds per batch beside the single prunes', the batched counters, peak
    memory, launches per batch. Then SERVE_TDS_BATCH with the complete TDS,
    each lane equal to its single prune, and the profiler over one more
    batch."""
    log(f"== phase 8b: R-MAT scale {SCALE_FULL}, {SERVE_QUERIES} queries "
        f"served in batches of {SERVE_MAX_BATCH} ({CARD})")
    templates = example_workload(SERVE_QUERIES, seed=1,
                                 labels_max=int(g.labels.max()))
    eng, t_stage = timed(lambda: GraphQueryEngine(
        g, max_batch=SERVE_MAX_BATCH, device=DEVICE,
        guarantee_precision=SERVE_PRECISION))
    ids = [eng.submit(t, mode=MODE_PRUNE) for t in templates]
    reset_peak()
    registry.reset_launches()
    results, secs = timed(eng.drain)
    launches = {k: registry.launch_counts()[k] for k in registry.PRUNE_KERNELS}
    peak = peak_gib()
    check(sorted(r.query_id for r in results) == ids
          and all(r.status == "ok" for r in results),
          "a query of the workload was dropped or missed")
    n_b = eng.stats["n_batches"]
    per_batch = {}
    for r in results:
        st = r.result.stats
        per_batch.setdefault(r.batch_id, batch_counters(st))
    lf = g.label_frequency()
    t_single = 0.0
    for r in results:
        res, s = timed(lambda: prune(dg, templates[r.query_id], label_freq=lf,
                                     guarantee_precision=SERVE_PRECISION))
        t_single += s
        check(same_lane(lane_arrays(r.result), lane_arrays(res)),
              f"query {r.query_id}: the batched lane differs from its single "
              f"prune")
        del res
    for k in registry.PRUNE_KERNELS:  # no kernel runs in a CPU rehearsal
        check(DEVICE != "cuda" or launches[k] > 0,
              f"{k} never launched serving the workload")
    log(f"staged the graph in {t_stage:.2f} s; served {len(results)} queries "
        f"in {secs:.3f} s ({len(results) / secs:.2f} q/s) in {n_b} batches "
        f"of {[b['B'] for b in eng.stats['batches']]}; seconds per batch "
        f"{[round(b['seconds'], 4) for b in eng.stats['batches']]}; the "
        f"{len(results)} single prunes {t_single:.3f} s in all")
    for bid, c in sorted(per_batch.items()):
        log(f"  batch {bid}: {c}")
    log(f"max_memory_allocated {peak:.3f} GiB; launches {launches} "
        f"({ {k: v / n_b for k, v in launches.items()} } per batch); every "
        f"lane's omega and edge mask equal its single prune's ({CARD})")
    # the complete-walk TDS (the reference's default) on a batch whose TDS
    # walks take well under a second here, so that the batched TDS bridge
    # (`tds_lane`) runs at this scale too
    tds_batch = [Template(*t) for t in SERVE_TDS_BATCH]
    registry.reset_launches()
    tres, t_tds = timed(lambda: prune_batch(g, tds_batch, dg=eng.dg))
    tds_launches = {k: registry.launch_counts()[k]
                    for k in registry.PRUNE_KERNELS}
    t_tds_single = 0.0
    for t, r in zip(tds_batch, tres.results):
        res, s = timed(lambda: prune(dg, t, label_freq=lf))
        t_tds_single += s
        check(same_lane(lane_arrays(r), lane_arrays(res)),
              f"{t.labels}: the batched lane with the complete TDS differs "
              f"from its single prune")
        del res
    check(tres.status == ["ok"] * len(tds_batch)
          and tres.stats.get("tds_gather_bridge", 0) >= len(tds_batch),
          "the complete TDS did not run in every lane")
    for k in registry.PRUNE_KERNELS:
        check(DEVICE != "cuda" or tds_launches[k] > 0,
              f"{k} never launched in the batch with the complete TDS")
    log(f"with the complete TDS: B={len(tds_batch)} {t_tds:.3f} s (the "
        f"single prunes {t_tds_single:.3f} s in all), "
        f"{[r.counts() for r in tres.results]}, "
        f"{batch_counters(tres.stats)}, launches {tds_launches}; every lane "
        f"equal to its single prune ({CARD})")
    first = templates[:SERVE_MAX_BATCH]
    profile_device(lambda: prune_batch(g, first, dg=eng.dg,
                                       guarantee_precision=SERVE_PRECISION),
                   1, "batch", "bitset_spmm")
    return {"launches": launches, "seconds": secs, "qps": len(results) / secs,
            "batch_seconds": [b["seconds"] for b in eng.stats["batches"]],
            "single_seconds": t_single, "peak_gib": peak, "batches": n_b}


def phase_incremental_full(g, dg):
    """Scale 20: `IncrementalSession` over the three revisions of
    examples/interactive_search.py; each result keeps every vertex of the
    single prune of its template (100% recall), inside the candidate set;
    then `exploratory_search` on the example's planted-squares recipe at
    scale 20 over EXPLORE_LABELS_FULL labels, which must find the planted
    squares at k = 2."""
    log(f"== phase 8c: R-MAT scale {SCALE_FULL} incremental and exploratory "
        f"search ({CARD})")
    labels, revisions = interactive_search.LABELS, interactive_search.REVISIONS
    lf = g.label_frequency()
    exact = [prune(dg, Template(labels, es), label_freq=lf).state.omega.any(dim=1)
             for es in revisions]
    sync()
    registry.reset_launches()
    session, t_cand = timed(lambda: IncrementalSession(
        g, Template(labels, revisions[0]), device=DEVICE))
    cand = session._cand.omega.any(dim=1)
    log(f"candidate set: {int(cand.sum())} vertices in {t_cand:.3f} s "
        f"(with staging the graph)")
    for es, want in zip(revisions, exact):
        state, stat = session.search(Template(labels, es))
        got = state.omega.any(dim=1)
        missed = int((want & ~got).sum())
        outside = int((got & ~cand).sum())
        log(f"  m0={stat.template_edges}: {stat.seconds:.4f} s, "
            f"{stat.matched_vertices} vertices (exact {int(want.sum())}), "
            f"{stat.constraints_reused}/{stat.constraints_checked} constraints "
            f"reused")
        check(missed == 0, f"revision m0={stat.template_edges} misses "
              f"{missed} vertices of the exact prune")
        check(outside == 0, f"revision m0={stat.template_edges} keeps "
              f"{outside} vertices outside the candidate set")
    launches = {k: registry.launch_counts()[k] for k in registry.PRUNE_KERNELS}
    log(f"launches {launches}; every revision keeps the exact prune's "
        f"vertices, inside the candidate set")
    for k in registry.PRUNE_KERNELS:
        check(DEVICE != "cuda" or launches[k] > 0,
              f"{k} never launched on the incremental path")

    t0 = time.perf_counter()
    gx = interactive_search.planted_squares(scale=SCALE_FULL,
                                            n_labels=EXPLORE_LABELS_FULL)
    t_gen = time.perf_counter() - t0
    ex, secs = timed(lambda: exploratory_search(
        gx, Template(*interactive_search.CLIQUE), device=DEVICE))
    log(f"exploratory search, n={gx.n} m={gx.m} (generated in {t_gen:.1f} s): "
        f"{secs:.3f} s, {ex.candidate_vertices} candidate vertices, found at "
        f"k={ex.found_level}")
    for lv in ex.levels:
        log(f"  k={lv.k}: {lv.n_variants} variants, matched "
            f"{lv.matched_vertices}, {lv.avg_seconds_per_variant * 1e3:.2f} "
            f"ms/variant")
    check(ex.found_level == 2, f"the planted squares were found at "
          f"k={ex.found_level}, not at k = 2")
    check(ex.vertex_mask[np.arange(gx.n - 12, gx.n)].all(),
          "a planted square is missing")
    return {"launches": launches}


def phase_batch_clis(scale=SERVE_CLI_SCALE):
    """`launch/serve.py --graph-queries 32` and `launch/interactive_search`
    in processes of their own."""
    log(f"== phase 8d: python -m repro_torch.launch.serve --graph-queries "
        f"{SERVE_QUERIES} --graph-scale {scale}; python -m "
        f"repro_torch.launch.interactive_search ({CARD})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for args, want in (
            (["repro_torch.launch.serve", "--graph-queries",
              str(SERVE_QUERIES), "--graph-scale", str(scale)],
             f"served {SERVE_QUERIES} queries on {DEVICE}"),
            (["repro_torch.launch.interactive_search"],
             f"incremental search on {DEVICE}")):
        t0 = time.perf_counter()
        if args[0].endswith("serve") or DEVICE == "cpu":
            args = args + ["--device", DEVICE]
        proc = subprocess.run(
            [sys.executable, "-m", *args],
            capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
        log(proc.stdout.strip())
        check(proc.returncode == 0, f"{args[0]} failed ({proc.returncode}): "
              f"{proc.stderr[-2000:]}")
        check(want in proc.stdout, f"{args[0]} did not run on {DEVICE}")
        log(f"{args[0]} exited 0 in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------- phase 9: a sharded graph
@contextlib.contextmanager
def segment_ors_held_to_plain():
    """Within the block, every `ops.bitset_segment_or` call (the
    `bitset_spmm` kernel on the card, the sharded receive side) is also
    computed by `ref.bitset_segment_or_ref` on the same inputs; yields the
    list of (source rows, out rows, arcs, W, max_abs_err) per call."""
    calls = []
    kernel = ops.bitset_segment_or

    def checked(vals, src, dst, dst_ptr, n_out, active=None):
        out = kernel(vals, src, dst, dst_ptr, n_out, active)
        want = ref.bitset_segment_or_ref(vals, src, dst, n_out, active)
        calls.append((vals.shape[0], n_out, int(src.shape[0]), vals.shape[1],
                      max_abs_err(out, want)))
        return out

    ops.bitset_segment_or = checked
    try:
        yield calls
    finally:
        ops.bitset_segment_or = kernel


def same_prune(res, want, what):
    """res equals want (a PruneResult or phase 4's host copies) in omega,
    the edge mask and the phase trajectory."""
    get = want.get if isinstance(want, dict) else (lambda k: {
        "omega": want.omega, "edge_mask": want.edge_mask,
        "traj": trajectory(want)}[k])
    check(np.array_equal(res.omega, get("omega")), f"{what}: omega differs")
    check(np.array_equal(res.edge_mask, get("edge_mask")),
          f"{what}: edge mask differs")
    check(trajectory(res) == get("traj"), f"{what}: phase trajectory differs")


def flavor_counts(res):
    """{flavor: (count, seconds)} through both sharded joins."""
    out = {}
    for flavor in SHARD_FLAVORS:
        cnt, s = timed(lambda: count_matches(res, route=flavor))
        out[flavor] = (cnt.n_embeddings, s)
    return out


PARITY9A = (("hex-unique", HEX), ("3c triangle", TRI_MANY))


def phase9a_cpu(g, out_dir):
    """9a's CPU side (in 10a's worker process): the port's CPU sim at each
    P of SHARDS_PARITY for each template, saved under out_dir (9a.npz, and
    9a.json last, when all is written)."""
    arrays, records = {}, {}
    for name, tt in PARITY9A:
        for P in SHARDS_PARITY:
            cpu, s_cpu = timed(lambda: prune(g, Template(*tt), device="cpu", partition=P))
            key = f"{name}-{P}"
            arrays[f"{key}-omega"], arrays[f"{key}-edge_mask"] = cpu.omega, cpu.edge_mask
            records[key] = {"traj": trajectory(cpu), "seconds": s_cpu,
                            "lcc_iterations": cpu.stats["lcc_iterations"]}
    np.savez(os.path.join(out_dir, "9a.npz"), **arrays)
    with open(os.path.join(out_dir, "9a.json.tmp"), "w") as f:
        json.dump(records, f)
    os.replace(os.path.join(out_dir, "9a.json.tmp"), os.path.join(out_dir, "9a.json"))


def phase9a_cpu_results(worker, timeout_s=600):
    """9a's CPU side from the worker: (arrays, records), waiting for them."""
    proc, out_dir = worker[0][0], worker[1]
    done = os.path.join(out_dir, "9a.json")
    end = time.monotonic() + timeout_s
    while not os.path.exists(done):
        if proc.poll() is not None or time.monotonic() > end:
            with open(os.path.join(out_dir, "worker-0.log")) as f:
                check(False, f"9a's CPU side did not arrive: {f.read()[-3000:]}")
        time.sleep(0.5)
    with open(done) as f:
        records = json.load(f)
    return np.load(os.path.join(out_dir, "9a.npz")), records


def phase_sharded_parity(g, worker):
    """Scale 14: the sim backend at P in SHARDS_PARITY on the card against
    the port's CPU sim (computed by 10a's worker process, `phase9a_cpu`) and
    the card's local prune, for hex-unique and the 3c triangle
    (multiplicity counts); every `bitset_segment_or` call of the P = 4
    prunes held bit for bit to the plain version."""
    log(f"== phase 9a: R-MAT scale {SCALE_PARITY}, the sim backend at P in "
        f"{SHARDS_PARITY}, card vs CPU vs the local prune ({CARD})")
    arrays, records = phase9a_cpu_results(worker)
    held_calls = []
    for name, tt in PARITY9A:
        tmpl = Template(*tt)
        local = prune(g, tmpl, device=DEVICE)
        local_count = count_matches(local).n_embeddings
        for P in SHARDS_PARITY:
            registry.reset_launches()
            with (segment_ors_held_to_plain() if P == 4
                  else contextlib.nullcontext([])) as calls:
                card, s_card = timed(lambda: prune(g, tmpl, device=DEVICE,
                                                   partition=P))
            spmm = registry.launch_counts()["bitset_spmm"]
            key = f"{name}-{P}"
            rec = records[key]
            same_prune(card, {"omega": arrays[f"{key}-omega"],
                              "edge_mask": arrays[f"{key}-edge_mask"],
                              "traj": [tuple(t) for t in rec["traj"]]},
                       f"9a {name} P={P} card vs CPU sim")
            same_prune(card, local, f"9a {name} P={P} sim vs the local prune")
            check(card.stats["lcc_iterations"] == rec["lcc_iterations"],
                  f"9a {name} P={P}: lcc_iterations differ card vs CPU")
            s_cpu = rec["seconds"]
            counts = flavor_counts(card)
            check(all(c == local_count for c, _ in counts.values()),
                  f"9a {name} P={P}: counts {counts} != {local_count}")
            check(spmm > 0, f"9a {name} P={P}: bitset_spmm never launched")
            held_calls += calls
            log(f"{name} P={P}: card {s_card:.3f} s, CPU {s_cpu:.2f} s, "
                f"{card.counts()}, lcc_iterations "
                f"{card.stats['lcc_iterations']} (local "
                f"{local.stats['lcc_iterations']}), routes "
                f"{card.stats['dispatch_routes']}, bitset_spmm launches {spmm}, "
                f"count {local_count} by both flavors")
    check(held_calls and all(c[-1] == 0 for c in held_calls),
          f"a bitset_segment_or call differs from the plain version: "
          f"{[c for c in held_calls if c[-1]]}")
    shapes = sorted({c[:4] for c in held_calls})
    log(f"9a: {len(held_calls)} bitset_segment_or calls of the P=4 prunes "
        f"bit-exact against the plain version, at (rows, out rows, arcs, W) "
        f"{shapes}")
    log("card == CPU == local prune: omega, edge mask, trajectory; "
        "lcc_iterations card == CPU; counts by both flavors")


def bucket_size(g, P):
    """The partition's bucket size B at P shards (`partition_graph`'s
    arithmetic, without building it)."""
    nl = (g.n + P - 1) // P
    b = int(np.bincount((g.src // nl).astype(np.int64) * P + g.dst // nl,
                        minlength=P * P).max())
    return -(-max(b, 1) // 8) * 8


def segment_or_cost(sa, w):
    """(bytes, operations) of one receive-side `bitset_segment_or` at packed
    width w, each input read once: every real received slot's source index,
    destination and active flag, its W words, the dst offsets, and the
    [Pl*n_local, W] output; one OR per word per slot."""
    arcs, n_out = int(sa.rx_src.shape[0]), int(sa.rx_ptr.shape[0]) - 1
    return arcs * (9 + 4 * w) + (n_out + 1) * 8 + n_out * 4 * w, arcs * w


def sweep_breakdown(be, wave, reps=5):
    """The first LCC sweep's pieces on a sharded backend, re-initialised
    (every arc active: the heaviest sweep), by CUDA events: the send-side
    gather, the exchange (a transpose under sim), the `bitset_segment_or`
    receive (with its plain version and bound) and the arc-wide twin test;
    and a hop of the packed frontier at this wave."""
    be.init(None)
    sa, prims, tm = be.sa, be.prims, be.tdev
    om, ea = be.omega_all, be.ea_all
    mask = ea & sa.send_live

    def gather():
        return engine._rows(om, engine._send_index(mask, sa)).view(
            sa.Pl, sa.P, sa.B, -1)

    msgs = gather()
    recv = prims.exchange(msgs)
    om_bits = unpack_bits(om[:, :sa.n_local], tm.n0)
    W = om.shape[-1]
    n_out = sa.Pl * sa.n_local

    def plain(buf):
        return ref.bitset_segment_or_ref(buf.reshape(-1, buf.shape[-1]),
                                         sa.rx_src, sa.rx_dst, n_out)

    # the sweep's receive and one hop's, each held bit for bit to the plain
    # version on the same inputs
    err = max_abs_err(engine._aggregate_or(recv, sa).view(n_out, W), plain(recv))
    check(err == 0, f"the sweep's bitset_segment_or at W={W} differs from "
          f"the plain version: max_abs_err {err}")
    t = {
        "gather_ms": time_ms(gather, reps),
        "exchange_ms": time_ms(lambda: prims.exchange(msgs), reps),
        "receive_ms": time_ms(lambda: engine._aggregate_or(recv, sa), reps),
        "receive_plain_ms": time_ms(lambda: plain(recv), 1),
        "receive_max_abs_err": err,
        "twin_test_ms": time_ms(lambda: engine._twin_test(
            om_bits, recv, mask, sa, tm), reps),
        "sweep_ms": time_ms(lambda: engine.lcc_shard_iteration(
            om, ea, sa, tm, prims), reps),
    }
    t["receive_bound_ms"], t["receive_bound_by"] = bound(segment_or_cost(sa, W))
    t["exchange_bytes"] = msgs.numel() * 4
    # one packed hop at this wave, from random frontier words with every
    # vertex a candidate
    wf = wave // 32
    rng_t = torch.Generator(device=om.device).manual_seed(SEED)
    cand = torch.ones((sa.Pl, sa.n_local), dtype=torch.bool, device=om.device)
    front = torch.randint(-2**31, 2**31 - 1, (sa.Pl, sa.n_local + 1, wf),
                          generator=rng_t, dtype=torch.int32, device=om.device)
    front[:, sa.n_local] = 0                       # the padding-sink row
    t["hop_ms"] = time_ms(lambda: engine.frontier_shard_hop(
        front[None], ea[None], sa, cand[None], prims), 2)
    recv_f = prims.exchange(engine._rows(front, sa.send_flat).view(
        sa.Pl, sa.P, sa.B, -1))
    err = max_abs_err(engine._aggregate_or(recv_f, sa).view(n_out, wf),
                      plain(recv_f))
    check(err == 0, f"a hop's bitset_segment_or at W={wf} differs from the "
          f"plain version: max_abs_err {err}")
    t["hop_receive_max_abs_err"] = err
    t["hop_receive_ms"] = time_ms(lambda: engine._aggregate_or(recv_f, sa), 2)
    t["hop_receive_bound_ms"], _ = bound(segment_or_cost(sa, wf))
    del msgs, recv, recv_f, front
    return t


def phase_sharded_full(g, ref4):
    """Scale SCALE_SHARDED: the sim backend at SHARDED_FULL, each prune
    equal to `ref4`, the local prune of that graph (omega, edge mask,
    trajectory, count) and
    keeping exactly what its matches use; seconds by phase and by join
    flavor, peak memory, bitset_spmm launches, the busy share, and one
    sweep's breakdown. -> (a row per P, the partitions by P)."""
    log(f"== phase 9b: R-MAT scale {SCALE_SHARDED}, the sim backend at "
        f"(P, wave) in {SHARDED_FULL} ({CARD})")
    tmpl = Template(*HEX)
    lf = g.label_frequency()
    rows, parts = [], {}
    for P, wave in SHARDED_FULL:
        part, s_part = timed(lambda: partition_graph(g, P))
        parts[P] = part  # phase 10 reuses it
        slots = P * P * part.B
        plane_gib = slots * (wave // 32) * 4 / 2**30
        reset_peak()
        registry.reset_launches()
        res, s_prune = timed(lambda: prune(g, tmpl, device=DEVICE,
                                           partition=part, wave=wave,
                                           label_freq=lf))
        spmm = registry.launch_counts()
        _, s_plan = timed(part.join_plan)
        counts = flavor_counts(res)
        peak = peak_gib()
        same_prune(res, ref4, f"9b P={P}")
        check(all(c == ref4["count"] for c, _ in counts.values()),
              f"9b P={P}: counts {counts} != the local prune's {ref4['count']}")
        check(spmm["bitset_spmm"] > 0, f"9b P={P}: bitset_spmm never launched")
        check(spmm["bitset_wave"] == 0, f"9b P={P}: the sharded path ran "
              "bitset_wave (its fused route is the reference's hop loop)")
        check_keeps_the_matches(res, tmpl)
        log(f"sharded sim P={P} wave={wave}: B={part.B} slots={slots} "
            f"pad={slots / g.m:.2f}x plane={plane_gib:.2f} GiB; partition "
            f"{s_part:.2f} s and its join plan {s_plan:.2f} s on the host; "
            f"prune {s_prune:.3f} s, its phases "
            f"{sum(p.seconds for p in res.phases):.3f} s (the local "
            f"prune's {ref4['seconds']:.3f} s); lcc_iterations "
            f"{res.stats['lcc_iterations']}, routes "
            f"{res.stats['dispatch_routes']}; count "
            + ", ".join(f"{fl} {s:.3f} s" for fl, (_, s) in counts.items())
            + f"; peak {peak:.3f} GiB; bitset_spmm launches "
            f"{spmm['bitset_spmm']}; {res.counts()}, {ref4['count']} matches,"
            " omega/edge mask/trajectory == the local prune, keeps exactly "
            "what the matches use")
        for p in res.phases:
            log(f"  {p.phase:11s} {str(p.constraint or ''):28s} "
                f"{p.seconds:9.4f} s waves={p.extra.get('nlcc_waves', '-')}")
        busy = profile_device(
            lambda: prune(g, tmpl, device=DEVICE, partition=part, wave=wave,
                          label_freq=lf), 1, f"sharded prune P={P}",
            "bitset_spmm")
        t = sweep_breakdown(res.backend, wave)
        registry.reset_launches()
        with segment_ors_held_to_plain() as held:
            again = prune(g, tmpl, device=DEVICE, partition=part, wave=wave,
                          label_freq=lf)
        same_prune(again, ref4, f"9b P={P} with its receives held")
        check(len(held) == registry.launch_counts()["bitset_spmm"] > 0
              and all(c[-1] == 0 for c in held),
              f"9b P={P}: a bitset_segment_or call differs from the plain "
              f"version: {[c for c in held if c[-1]]}")
        log(f"  9b P={P}: all {len(held)} bitset_segment_or calls of one more "
            f"prune bit-exact against the plain version, at (rows, out rows, "
            f"arcs, W) {sorted({c[:4] for c in held})}")
        del again
        log(f"  first sweep at P={P}: {t['sweep_ms']:.3f} ms = gather "
            f"{t['gather_ms']:.3f} + exchange {t['exchange_ms']:.3f} "
            f"({t['exchange_bytes'] / 2**20:.0f} MiB transposed) + receive "
            f"bitset_segment_or {t['receive_ms']:.4f} (plain "
            f"{t['receive_plain_ms']:.2f}, bound {t['receive_bound_ms']:.4f} "
            f"by {t['receive_bound_by']}) + twin test {t['twin_test_ms']:.3f} "
            f"+ the rest; one packed hop at wave {wave}: {t['hop_ms']:.3f} ms, "
            f"its receive {t['hop_receive_ms']:.3f} (bound "
            f"{t['hop_receive_bound_ms']:.3f})")
        rows.append({"P": P, "wave": wave, "B": part.B, "slots": slots,
                     "prune_s": round(s_prune, 4), "peak_gib": round(peak, 3),
                     "launches": spmm["bitset_spmm"],
                     "busy_ms": busy, **{k: (round(v, 4) if isinstance(v, float)
                                             else v) for k, v in t.items()}})
        del res
    slots8 = 8 * 8 * bucket_size(g, 8)
    log(f"P=8 runs in 9a only: at scale {SCALE_SHARDED} its buckets hold "
        f"{slots8} slots, {slots8 * 128 / 2**30:.1f} GiB a frontier plane at "
        f"wave 1024, and a hop holds two")
    return rows, parts


def phase_spmd_nccl(g, ref4):
    """Scale SCALE_SHARDED: the spmd backend on an NCCL group of one rank
    (file:// rendezvous in a temporary directory), against the sim backend
    at P = 1 and the local prune (`ref4`), both on one P = 1 partition. ->
    (a row, the partition)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_shard_group

    log(f"== phase 9c: R-MAT scale {SCALE_SHARDED}, spmd on one NCCL rank vs "
        f"sim P=1 vs the local prune ({CARD})")
    tmpl = Template(*HEX)
    lf = g.label_frequency()
    part, s_part = timed(lambda: partition_graph(g, 1))
    sim, s_sim = timed(lambda: prune(g, tmpl, device=DEVICE, partition=part,
                                     label_freq=lf))
    same_prune(sim, ref4, "9c sim P=1")
    with tempfile.TemporaryDirectory() as d:
        group = make_shard_group(1, backend="nccl", rank=0,
                                 init_method=f"file://{d}/rendezvous")
        try:
            registry.reset_launches()
            res, s_spmd = timed(lambda: prune(g, tmpl, mesh=group,
                                              partition=part, label_freq=lf))
            spmm = registry.launch_counts()["bitset_spmm"]
            check(res.stats["backend"] == "spmd", "9c: not the spmd backend")
            same_prune(res, sim, "9c spmd vs sim P=1")
            same_prune(res, ref4, "9c spmd vs the local prune")
            check(res.stats["lcc_iterations"] == sim.stats["lcc_iterations"],
                  "9c: lcc_iterations differ spmd vs sim")
            counts = flavor_counts(res)
            check(all(c == ref4["count"] for c, _ in counts.values()),
                  f"9c: counts {counts} != {ref4['count']}")
            check(spmm > 0, "9c: bitset_spmm never launched")
        finally:
            dist.destroy_process_group()
    log(f"spmd (nccl, 1 rank): prune {s_spmd:.3f} s, sim P=1 {s_sim:.3f} s "
        f"(the P=1 partition {s_part:.2f} s on the host); "
        f"lcc_iterations {res.stats['lcc_iterations']}; bitset_spmm launches "
        f"{spmm}; count " + ", ".join(f"{fl} {s:.3f} s" for fl, (_, s)
                                      in counts.items())
        + "; omega/edge mask/trajectory/count == sim P=1 == the local prune")
    return {"prune_s": round(s_spmd, 4), "launches": spmm}, part


# ---------------------- phase 10: resilience, rebalance, sharded batches
# 10a runs the scenarios of tests/test_torch_resilience.py on the sim at
# RES_P shards, restarts onto RES_RESTART_P, each template at its wave (the
# hex-unique's six walks give wave indices 0-5 at any wave size; 32 keeps
# its CPU run short)
RES_P, RES_RESTART_P = 4, 2
RES_TEMPLATES = (("hex-unique", HEX, 32), ("3c triangle", TRI_MANY, WAVE))
RES_RANDOM_SEED = 1
# 10b: the skew that triggers the rebalance, at scale 18 (SCALE_SHARDED).
# The first boundary's active arcs sit on the hubs' shards (low ids): 1.716
# at P = 4, and within a few percent after the shuffle. A rebalance onto
# P = 4 moves a second time at the next boundary, where the 96 arcs left
# read 1.250 over 4 shards; onto P = 2 they read 1.208 and it moves once,
# onto 1 once (read with a trigger of 1.0001 on the card). At scale 20, 1.5
# set the same pattern (1.600; 36 arcs at 1.556 over 4 shards)
IMBALANCE_TRIGGER = 1.23
CKPT_WAVE = 512
# 10c: the sharded batch's templates, batch 1 of 8b's drain (its rounds
# are few at scale 20), and its engine's queries in count mode: 8b's TDS
# batch with every label one lower, the weak-scaling relabel from scale 20
# to SCALE_SHARDED (R-MAT's hub degrees fall about 2.3x, a label
# ceil(log2(d + 1)) about one). Unshifted, the label-10/11 triangles
# select scale 18's dense hub core: 4,687,540 matches, 135 s of counting
# on P = 2 and 128 s on one shard, against 4,500 and 7.8 s shifted (a
# probe on the H100). The waves its budget chooses from. A job's hop sends wave/32 words a slot; past 2
# the receive kernel runs a warp per vertex, which R-MAT's hubs hold up
# (9b), and a round's lone straggler job runs there alone: at wave 128 the
# batch took 9.693 s and the engine 207.709 s, at 64 2.971 s and 57.693 s
SHARDED_BATCH_WAVES = (64, 32)
SHARDED_BATCH = slice(8, 12)
ENGINE_QUERIES = [([lab - 1 for lab in labels], edges)
                  for labels, edges in SERVE_TDS_BATCH + SERVE_TDS_BATCH[:2]]


def resilience_scenarios(K, k_tds):
    """10a's scenarios for a template of K constraints whose TDS is phase
    k_tds (None without one): [(name, cfg(checkpoint_dir))]."""
    from repro_torch.core import resilience as res

    def loss(**kw):
        return res.FaultSpec(kind=res.FAULT_SHARD_LOSS, **kw)

    def restarting(specs):
        return lambda d: res.ResilienceConfig(
            checkpoint_dir=d, injector=res.FaultInjector(specs),
            elastic=res.ElasticConfig(restart_P=RES_RESTART_P))

    out = [(f"shard loss at phase {k}", restarting([loss(phase=k)]))
           for k in range(K + 1)]
    out.append(("mid-wave loss (wave 1)",
                restarting([loss(phase=1, site="wave", wave=1)])))
    out.append(("seeded random plan", lambda d: res.ResilienceConfig(
        checkpoint_dir=d, injector=res.FaultInjector.random(
            RES_RANDOM_SEED, n_phases=K + 1, n_faults=2),
        elastic=res.ElasticConfig(restart_P=RES_RESTART_P))))
    out.append(("collective retry", lambda d: res.ResilienceConfig(
        injector=res.FaultInjector([res.FaultSpec(
            kind=res.FAULT_COLLECTIVE_TIMEOUT, phase=1,
            cleared_by="retry")]))))
    out.append(("kernel fault, ref rung", lambda d: res.ResilienceConfig(
        injector=res.FaultInjector([res.FaultSpec(
            kind=res.FAULT_TRANSIENT_KERNEL, phase=1, cleared_by="ref",
            times=0)]))))
    if k_tds is not None:
        out.append(("chunk back-off", lambda d: res.ResilienceConfig(
            injector=res.FaultInjector([res.FaultSpec(
                kind=res.FAULT_RESOURCE_EXHAUSTED, phase=k_tds, site="tds",
                cleared_by="chunk")]))))
    out.append(("imbalance-triggered rebalance", lambda d: res.ResilienceConfig(
        elastic=res.ElasticConfig(imbalance_trigger=1.0,
                                  rebalance_P=RES_RESTART_P))))
    return out


def plan_shape(res):
    """(K, the TDS phase or None) of a prune result."""
    phases = res.stats["plan"]["phases"]
    tds = [k + 1 for k, p in enumerate(phases) if p["engine"] == "tds"]
    return len(phases), (tds[0] if tds else None)


def resilience_records(res, inj):
    """What 10a holds card against CPU: the ladder, the restarts, the
    rebalances, the faults fired (JSON-able)."""
    rs = res.stats["resilience"]
    return {
        "ladder": [list(x) for x in rs["ladder"]],
        "restarts": [[r["cause"], r["restored_phase"], r["from_P"], r["to_P"]]
                     for r in rs["restarts"]],
        "rebalances": [[r["phase"], r["from_P"], r["to_P"],
                        r["max_over_mean_before"]] for r in rs["rebalances"]],
        "checkpoints": rs["checkpoints"],
        "fired": [dict(f) for f in (inj.fired if inj is not None else [])],
    }


def shifted_batch():
    return [Template([lab + BATCH_LABEL_SHIFT for lab in labels], edges)
            for labels, edges in BATCH_VARIANTS]


def phase10_cpu_worker(out_dir, part, threads=3):
    """9a's and 10a's CPU sides, in two processes (part 0 and 1) while the
    card runs phases 2-10c: part 0 9a's sims (`phase9a_cpu`), then 10a's
    scenarios of the first template; part 1 those of the second, then the
    sharded batches at P = 2 and 4; saved under out_dir (arrays as .npz,
    records as records-<part>.json)."""
    torch.set_num_threads(threads)
    g = gen.rmat_graph(SCALE_PARITY, edge_factor=EDGE_FACTOR, seed=SEED)
    if part == 0:
        phase9a_cpu(g, out_dir)
    records = {}
    for tname, spec, wave in RES_TEMPLATES[part:part + 1]:
        tmpl = Template(*spec)
        base = prune(g, tmpl, device="cpu", partition=RES_P, wave=wave)
        K, k_tds = plan_shape(base)
        for i, (name, cfg_of) in enumerate(resilience_scenarios(K, k_tds)):
            with tempfile.TemporaryDirectory() as d:
                cfg = cfg_of(d)
                res = prune(g, tmpl, device="cpu", partition=RES_P, wave=wave,
                            resilience=cfg)
            np.savez(os.path.join(out_dir, f"{tname}-{i}.npz"),
                     omega=res.omega, edge_mask=res.edge_mask)
            records[f"{tname}-{i}"] = dict(
                resilience_records(res, cfg.injector), traj=trajectory(res))
    for P in (2, 4) if part == 1 else ():
        bres = prune_batch(g, shifted_batch(), device="cpu", partition=P)
        np.savez(os.path.join(out_dir, f"batch-{P}.npz"), **{
            f"{k}{i}": a for i, r in enumerate(bres.results)
            for k, a in zip(("omega", "ea"), lane_arrays(r))})
        records[f"batch-{P}"] = batch_counters(bres.stats)
    with open(os.path.join(out_dir, f"records-{part}.json"), "w") as f:
        json.dump(records, f)


def start_phase10_worker():
    """(the two worker processes, their output directory, the start): the
    CPU sides of 9a and 10a, started now so that they run beside the card's
    phases."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_10a_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for part in (0, 1):
        with open(os.path.join(out_dir, f"worker-{part}.log"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke as cs; "
                 f"cs.phase10_cpu_worker({out_dir!r}, {part})"],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
    return procs, out_dir, time.perf_counter()


def stop_worker(worker):
    for proc in worker[0]:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def plain_calls():
    return sum(registry.plain_counts().values())


def phase_resilience_parity(g, worker):
    """10a, scale 14: the resilience scenarios on the sim at RES_P shards,
    each equal to the fault-free card prune (itself equal to the card's
    local prune) with the CPU run's records; plain-version calls on the
    card only on the ref rung. Then `prune_batch` of 8a's templates at P = 2
    and 4, each lane equal to its single sharded prune and to the CPU's,
    every receive-side call of the P = 4 batch held to the plain version."""
    log(f"== phase 10a: R-MAT scale {SCALE_PARITY}, faults on the sim at "
        f"P={RES_P} (restarts onto {RES_RESTART_P}), card vs CPU ({CARD})")
    procs, out_dir, t_started = worker
    cpu = {}
    for part, proc in enumerate(procs):
        proc.wait(timeout=900)
        with open(os.path.join(out_dir, f"worker-{part}.log")) as f:
            check(proc.returncode == 0,
                  f"10a's CPU worker {part} failed: {f.read()[-3000:]}")
        with open(os.path.join(out_dir, f"records-{part}.json")) as f:
            cpu.update(json.load(f))
    log(f"9a's and 10a's CPU workers: {time.perf_counter() - t_started:.1f} s since "
        f"they started, beside phases 2-10c")
    for tname, spec, wave in RES_TEMPLATES:
        tmpl = Template(*spec)
        local = prune(g, tmpl, device=DEVICE, wave=wave)
        registry.reset_launches()
        base, s_base = timed(lambda: prune(g, tmpl, device=DEVICE,
                                           partition=RES_P, wave=wave))
        same_prune(base, local, f"10a {tname}: fault-free sim vs local")
        check(plain_calls() == 0, f"10a {tname}: the fault-free prune ran "
              "a plain version on the card")
        K, k_tds = plan_shape(base)
        log(f"{tname} (wave {wave}): fault-free sim P={RES_P} {s_base:.3f} s "
            f"== the local prune; {K} constraints, TDS at phase {k_tds}")
        for i, (name, cfg_of) in enumerate(resilience_scenarios(K, k_tds)):
            with tempfile.TemporaryDirectory() as d:
                cfg = cfg_of(d)
                registry.reset_launches()
                res, s = timed(lambda: prune(g, tmpl, device=DEVICE,
                                             partition=RES_P, wave=wave,
                                             resilience=cfg))
            plain = plain_calls()
            key = f"{tname}-{i}"
            rec = dict(resilience_records(res, cfg.injector),
                       traj=trajectory(res))
            got = np.load(os.path.join(out_dir, f"{key}.npz"))
            same_prune(res, base, f"10a {tname} {name}")
            check(np.array_equal(res.omega, got["omega"])
                  and np.array_equal(res.edge_mask, got["edge_mask"]),
                  f"10a {tname} {name}: card != CPU")
            check(json.loads(json.dumps(rec)) == cpu[key],
                  f"10a {tname} {name}: records differ card vs CPU: {rec} "
                  f"vs {cpu[key]}")
            if "ref rung" in name:
                # on the card the rung runs the plain versions there, counted
                check((plain > 0 or DEVICE != "cuda")
                      and res.stats["resilience"]["plain_calls"]
                      == registry.plain_counts(),
                      f"10a {tname}: the ref rung ran no plain version")
            else:
                check(plain == 0, f"10a {tname} {name}: {plain} plain-version "
                      "calls on the card")
            rs = res.stats["resilience"]
            log(f"  {name}: {s:.3f} s, ladder {[r for r, _ in rs['ladder']]}, "
                f"restarts {rec['restarts']}, rebalances "
                f"{[r[:3] for r in rec['rebalances']]}, fired "
                f"{[(f['kind'], f['site'], f['phase'], f['wave']) for f in rec['fired']]}"
                f", plain-version calls {plain}: == fault-free == CPU")
    batch = shifted_batch()
    for P in (2, 4):
        registry.reset_launches()
        with (segment_ors_held_to_plain() if P == 4
              else contextlib.nullcontext([])) as held:
            bres, s = timed(lambda: prune_batch(g, batch, device=DEVICE,
                                                partition=P))
        spmm = registry.launch_counts()["bitset_spmm"]
        got = np.load(os.path.join(out_dir, f"batch-{P}.npz"))
        check(batch_counters(bres.stats) == cpu[f"batch-{P}"],
              f"10a batch P={P}: counters differ card vs CPU")
        check(plain_calls() == 0, f"10a batch P={P}: plain-version calls")
        check(DEVICE != "cuda" or spmm > 0,
              f"10a batch P={P}: bitset_spmm never launched")
        for i, (t, lane) in enumerate(zip(batch, bres.results)):
            single = prune(g, t, device=DEVICE, partition=P)
            check(same_lane(lane_arrays(lane), lane_arrays(single)),
                  f"10a batch P={P} lane {i}: != its single sharded prune")
            check(same_lane(lane_arrays(lane), (got[f"omega{i}"],
                                                got[f"ea{i}"])),
                  f"10a batch P={P} lane {i}: card != CPU")
        if P == 4:
            check(held and (DEVICE != "cuda" or len(held) == spmm)
                  and all(c[-1] == 0 for c in held),
                  f"10a batch P=4: a bitset_segment_or call differs from the "
                  f"plain version: {[c for c in held if c[-1]]}")
        log(f"prune_batch of 8a's 8 templates at P={P}: {s:.3f} s, "
            f"{batch_counters(bres.stats)}, bitset_spmm {spmm}"
            + (f", all {len(held)} receive calls bit-exact against the plain "
               f"version at (rows, out rows, arcs, W) "
               f"{sorted({c[:4] for c in held})}" if P == 4 else "")
            + "; every lane == its single sharded prune == CPU")


def handoff_line(h):
    """One handoff's timings and sizes, printed."""
    if not h:
        return "no handoff"
    pad = h["P"] * h["P"] * h["B"] / max(h["m"], 1) if "P" in h else None
    return (f"handoff compact {h['compact_s']:.3f} + shuffle "
            f"{h['shuffle_s']:.3f} + partition {h['partition_s']:.3f} s; "
            f"compacted n={h['n']} m={h['m']} B={h['B']}"
            + (f" (padding {pad:.2f}x m)" if pad is not None else "")
            + (f"; the old skew read on the host in {h['skew_s']:.3f} s"
               if "skew_s" in h else "")
            + (f"; max/mean {h['max_over_mean_before']:.3f} -> "
               f"{h['max_over_mean_after']:.3f}, Gini "
               f"{h['gini_before']:.3f} -> {h['gini_after']:.3f}"
               if "max_over_mean_before" in h else
               f"; after: max/mean {h['max_over_mean_after']:.3f}, Gini "
               f"{h['gini_after']:.3f}"))


def phase_checkpoint_rebalance(g, ref4, parts, part1, unbalanced_s):
    """10b, scale SCALE_SHARDED, 9b's graph, hex-unique: (i) a shard loss at
    phase 1 restarted onto P = 2 from the phase checkpoints, (ii)-(iv) the
    skew-triggered rebalance at the first boundary onto P = 4, 1 and 2, (v)
    a collective timeout retried in place on one NCCL rank; each equal to
    the local prune (`ref4`) with no plain-version call. -> rows."""
    import torch.distributed as dist
    from repro_torch.core import resilience as res
    from repro_torch.launch.mesh import make_shard_group

    log(f"== phase 10b: R-MAT scale {SCALE_SHARDED}, checkpoint and rebalance, "
        f"hex-unique from the sim at P=4 (wave {CKPT_WAVE}) ({CARD})")
    tmpl = Template(*HEX)
    lf = g.label_frequency()
    # (name, config, moves: a restart, or the rebalances at boundaries 0
    # and 1 as IMBALANCE_TRIGGER's comment says)
    runs = [
        ("(i) shard loss at phase 1, restart onto P=2",
         lambda d: res.ResilienceConfig(
             checkpoint_dir=d, injector=res.FaultInjector([res.FaultSpec(
                 kind=res.FAULT_SHARD_LOSS, phase=1)]),
             elastic=res.ElasticConfig(restart_P=2)), 1)]
    for to_P, tag in ((4, "(ii) LB-16"), (1, "(iii) LB-1"), (2, "(iv)")):
        runs.append((f"{tag} rebalance onto P={to_P}",
                     lambda d, to_P=to_P: res.ResilienceConfig(
                         checkpoint_dir=d, elastic=res.ElasticConfig(
                             imbalance_trigger=IMBALANCE_TRIGGER,
                             rebalance_P=to_P)), 2 if to_P == 4 else 1))
    rows = []
    for name, cfg_of, n_moves in runs:
        with tempfile.TemporaryDirectory() as d:
            reset_peak()
            registry.reset_launches()
            out, s = timed(lambda: prune(
                g, tmpl, device=DEVICE, partition=parts[4], wave=CKPT_WAVE,
                label_freq=lf, resilience=cfg_of(d)))
            launches = {k: registry.launch_counts()[k]
                        for k in registry.PRUNE_KERNELS}
            peak = peak_gib()
        same_prune(out, ref4, f"10b {name}")
        check(plain_calls() == 0, f"10b {name}: plain-version calls")
        check(DEVICE != "cuda" or launches["bitset_spmm"] > 0,
              f"10b {name}: no bitset_spmm")
        rs = out.stats["resilience"]
        moves = rs["restarts"] or rs["rebalances"]
        check(len(moves) == n_moves and out.backend is None
              and (rs["restarts"] or [m["phase"] for m in moves]
                   == list(range(n_moves))),
              f"10b {name}: moves {[m.get('phase') for m in moves]}, "
              f"expected {n_moves} from the first boundary on")
        move_s = sum(m["seconds"] for m in moves)
        if name.startswith("(iii)"):
            check(DEVICE != "cuda" or launches["bitset_wave"] > 0,
                  "10b (iii): the local backend "
                  "after the rebalance onto one shard ran no bitset_wave")
        hs = []
        for m in moves:
            h = dict(m.get("handoff") or {}, P=m["to_P"])
            if "max_over_mean_before" in m:
                h.update(max_over_mean_before=m["max_over_mean_before"],
                         gini_before=m["gini_before"])
            hs.append(h)
        log(f"{name}: prune {s:.3f} s, {move_s:.3f} s of it in moves "
            f"(9b's unbalanced P=4 prune {unbalanced_s:.3f} s); checkpoints {rs['checkpoints']}, bytes "
            f"{rs['checkpoint_bytes']}, seconds "
            f"{[round(x, 4) for x in rs['checkpoint_seconds']]}; "
            + (f"restore {rs['restarts'][0]['restore_seconds']:.3f} s; "
               if rs["restarts"] else "")
            + "; ".join(
                f"move at phase {m.get('phase', m.get('restored_phase'))} "
                f"{m['from_P']}->{m['to_P']} in {m['seconds']:.3f} s: "
                f"{handoff_line(h)}" for m, h in zip(moves, hs))
            + f"; peak {peak:.3f} GiB; launches {launches}; == the local prune")
        for p in out.phases:
            log(f"  {p.phase:11s} {str(p.constraint or ''):28s} "
                f"{p.seconds:9.4f} s E*={p.active_edges}")
        rows.append({"run": name, "prune_s": round(s, 4),
                     "move_s": [round(m["seconds"], 4) for m in moves],
                     "peak_gib": round(peak, 3),
                     "launches": launches, "handoffs": hs,
                     "checkpoint_bytes": rs["checkpoint_bytes"],
                     "checkpoint_s": rs["checkpoint_seconds"],
                     "restore_s": (rs["restarts"][0]["restore_seconds"]
                                   if rs["restarts"] else None)})
        del out
    with tempfile.TemporaryDirectory() as d:
        group = make_shard_group(1, backend="nccl", rank=0,
                                 init_method=f"file://{d}/rendezvous")
        try:
            inj = res.FaultInjector([res.FaultSpec(
                kind=res.FAULT_COLLECTIVE_TIMEOUT, phase=1,
                cleared_by="retry")])
            registry.reset_launches()
            out, s = timed(lambda: prune(
                g, tmpl, mesh=group, partition=part1, label_freq=lf,
                resilience=res.ResilienceConfig(checkpoint_dir=d,
                                                injector=inj)))
            spmm = registry.launch_counts()["bitset_spmm"]
        finally:
            dist.destroy_process_group()
    same_prune(out, ref4, "10b (v) spmd retry")
    rs = out.stats["resilience"]
    check(out.stats["backend"] == "spmd" and [r for r, _ in rs["ladder"]]
          == ["retry"] and not rs["restarts"], "10b (v): not one retry on spmd")
    check(plain_calls() == 0 and (DEVICE != "cuda" or spmm > 0),
          "10b (v): plain calls or no kernel")
    log(f"(v) one-rank NCCL spmd, a collective timeout at phase 1 retried in "
        f"place: {s:.3f} s, ladder {rs['ladder']}, checkpoints "
        f"{rs['checkpoints']} ({[round(x, 4) for x in rs['checkpoint_seconds']]} s)"
        f", bitset_spmm {spmm}; == the local prune")
    rows.append({"run": "(v) spmd retry", "prune_s": round(s, 4),
                 "launches": {"bitset_spmm": spmm}})
    return rows


def lockstep_wave(part, jobs):
    """The largest of SHARDED_BATCH_WAVES at which `jobs` NLCC jobs of the
    P-shard sim fit one lockstep group's budget. The allocator's cache is
    emptied first, so the free memory the budget reads (here and in the
    batch that follows) is what the live tensors leave, the same on every
    run of one tree."""
    from repro_torch.core.batch import LOCKSTEP_MEMORY_FRACTION, lockstep_job_bytes

    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    budget = (torch.cuda.mem_get_info()[0] * LOCKSTEP_MEMORY_FRACTION
              if DEVICE == "cuda" else 1 << 30)
    for wave in SHARDED_BATCH_WAVES:
        if jobs * lockstep_job_bytes(part.P, part.P, part.B, part.n_local,
                                     wave) <= budget:
            return wave, budget
    return 32, budget


def phase_sharded_batches(g, parts):
    """10c, scale SCALE_SHARDED: `prune_batch` of 4 same-bucket templates on the sim at
    P = 2, the wave (64 or 32) set by the lockstep group budget, each lane
    equal to its single P = 2 prune and to the P = 1 batch;
    `GraphQueryEngine(partition=)` serving 8 queries in count mode against
    the one-shard engine, both at that wave; the serving CLI with
    --partition 2. -> a row."""
    from repro_torch.core.batch import lockstep_job_bytes

    part = parts[2]
    log(f"== phase 10c: R-MAT scale {SCALE_SHARDED}, sharded batches on the sim "
        f"at P={part.P} ({CARD})")
    lf = g.label_frequency()
    templates = example_workload(SERVE_QUERIES, seed=1,
                                 labels_max=int(g.labels.max()))[SHARDED_BATCH]
    dg, s_stage = timed(lambda: DeviceGraph.from_host(
        g, DEVICE, order=part.dst_order(g)))
    wave, budget = lockstep_wave(part, len(templates))
    job = lockstep_job_bytes(part.P, part.P, part.B, part.n_local, wave)
    reset_peak()
    registry.reset_launches()
    bres, s = timed(lambda: prune_batch(
        g, templates, partition=part, wave=wave, dg=dg, label_freq=lf,
        guarantee_precision=SERVE_PRECISION))
    launches = {k: registry.launch_counts()[k] for k in registry.PRUNE_KERNELS}
    peak = peak_gib()
    check(plain_calls() == 0, "10c: plain-version calls in the sharded batch")
    check(DEVICE != "cuda" or launches["bitset_spmm"] > 0,
          "10c: bitset_spmm never launched")
    lock = bres.stats["batched"].get("lockstep", {})
    one, s_one = timed(lambda: prune_batch(
        g, templates, wave=wave, dg=dg, label_freq=lf,
        guarantee_precision=SERVE_PRECISION))
    t_single = 0.0
    for i, (t, lane) in enumerate(zip(templates, bres.results)):
        single, s1 = timed(lambda: prune(
            g, t, device=DEVICE, partition=part, wave=wave, label_freq=lf,
            guarantee_precision=SERVE_PRECISION))
        t_single += s1
        check(same_lane(lane_arrays(lane), lane_arrays(single)),
              f"10c lane {i}: != its single P={part.P} prune")
        check(same_lane(lane_arrays(lane), lane_arrays(one.results[i])),
              f"10c lane {i}: != the P=1 batch's lane")
        del single
    log(f"prune_batch B={len(templates)} at P={part.P}, wave {wave} (one "
        f"job's frontiers and planes {job / 2**30:.2f} GiB, the group budget "
        f"{budget / 2**30:.1f} GiB; jobs per group {lock.get('jobs_per_group')}"
        f"): {s:.3f} s, {batch_counters(bres.stats)}, launches {launches}, "
        f"peak {peak:.3f} GiB; the P=1 batch {s_one:.3f} s; the single P="
        f"{part.P} prunes {t_single:.3f} s in all, each at wave {wave}; every "
        f"lane == its single prune == the P=1 batch")
    queries = [Template(*q) for q in ENGINE_QUERIES]
    counts = {}
    for P, kw in ((part.P, {"partition": part}), (1, {})):
        if DEVICE == "cuda":
            torch.cuda.empty_cache()   # the engine's group budget, as above
        eng, s_eng = timed(lambda: GraphQueryEngine(
            g, device=DEVICE, max_batch=len(queries), wave=wave, **kw))
        ids = [eng.submit(q, mode=MODE_COUNT) for q in queries]
        registry.reset_launches()
        results, s_drain = timed(eng.drain)
        check([r.query_id for r in results] == ids
              and all(r.status == "ok" for r in results),
              f"10c engine P={P}: a query was dropped or missed")
        counts[P] = [r.n_embeddings for r in results]
        log(f"GraphQueryEngine P={P}, wave {wave}: {len(results)} queries in "
            f"count mode in "
            f"{s_drain:.3f} s ({len(results) / s_drain:.2f} q/s; the engine "
            f"built in {s_eng:.2f} s), batches "
            f"{[(b['B'], round(b['seconds'], 3)) for b in eng.stats['batches']]}"
            f", waits {[round(r.wait_s, 3) for r in results]} s, counts "
            f"{counts[P]}, bitset_spmm {registry.launch_counts()['bitset_spmm']}")
        check(plain_calls() == 0, f"10c engine P={P}: plain-version calls")
        del eng, results
    check(counts[part.P] == counts[1], "10c: the sharded engine's counts "
          "differ from the one-shard engine's")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = ["repro_torch.launch.serve", "--graph-queries", "8",
            "--graph-scale", str(SERVE_CLI_SCALE), "--partition", "2",
            "--device", DEVICE]
    proc, s_cli = timed(lambda: subprocess.run(
        [sys.executable, "-m", *args], capture_output=True, text=True,
        env=env, timeout=600, cwd=ROOT))
    log(proc.stdout.strip())
    check(proc.returncode == 0 and "P=2 shards" in proc.stdout,
          f"serve --partition 2 failed ({proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    log(f"python -m {' '.join(args)} exited 0 in {s_cli:.1f} s")
    return {"wave": wave, "seconds": round(s, 4), "launches": launches,
            "peak_gib": round(peak, 3), "job_gib": round(job / 2**30, 3),
            "jobs_per_group": lock.get("jobs_per_group")}


# ------------------------------------------------------------- phase 5: GNN
def gnn_setup():
    """(config, shape, classes) of the GNN path."""
    mod = get_arch(GNN_ARCH)
    return mod.CONFIG, mod.SHAPES[GNN_SHAPE], GNN_CLASSES[GNN_SHAPE]


def agg_shapes(shape, cfg):
    """The [NT, D, F] of the three segment_agg calls of one sampled forward:
    second-hop neighbours, first-hop neighbours, layer-1 representations."""
    b, (f1, f2) = shape.batch_nodes, shape.fanout
    return [(b * f1, f2, shape.d_feat), (b, f1, shape.d_feat),
            (b, f1, cfg.d_hidden)]


def agg_close(got, want):
    """min and max bit-exact, sum and sum of squares within AGG_TOL."""
    return (torch.equal(got[:, 1:3], want[:, 1:3])
            and torch.allclose(got[:, 0::3], want[:, 0::3],
                               rtol=AGG_TOL, atol=AGG_TOL))


def phase_segment_agg_small():
    """segment_agg against its plain version on the card."""
    log("== phase 5a: segment_agg vs its plain version")
    rng = np.random.default_rng(SEED)
    dev = DEVICE
    n_checks = 0
    for nt in (1, 7, 16, 33):
        for d in (1, 4, 10, 25):
            for f in (1, 3, 128, 602):
                for dtype in (torch.float32, torch.bfloat16):
                    x = rng.standard_normal((nt, d, f), dtype=np.float32)
                    m = rng.random((nt, d)) < 0.7
                    m[nt // 2] = False            # a row with no neighbour
                    x[~m] = np.nan if n_checks % 2 else np.inf  # must not leak
                    xt = torch.from_numpy(x).to(dev).to(dtype)
                    mt = torch.from_numpy(m).to(dev)
                    got = ops.segment_agg(xt, mt)
                    want = ref.segment_agg_ref(xt, mt)
                    sync()
                    check(agg_close(got, want) and bool(torch.isfinite(got).all()),
                          f"segment_agg [{nt},{d},{f}] {dtype} differs")
                    n_checks += 1
    # base pointers that are not aligned to a vector load (V falls to 1)
    for f, dtype in ((128, torch.float32), (602, torch.bfloat16)):
        flat = torch.randn(7 * 5 * f + 1, device=dev).to(dtype)
        xt = flat[1:].view(7, 5, f)
        mt = torch.from_numpy(rng.random((7, 5)) < 0.7).to(dev)
        check(agg_close(ops.segment_agg(xt, mt), ref.segment_agg_ref(xt, mt)),
              f"segment_agg on an unaligned [7,5,{f}] {dtype} view differs")
        n_checks += 1
    # an input that requires grad takes the autograd Function: the kernel
    # forward, the plain backward (phase 11b holds it at full width)
    xg = torch.randn((7, 5, 9), device=dev, requires_grad=True)
    mg = torch.from_numpy(rng.random((7, 5)) < 0.7).to(dev)
    before = registry.launch_counts()["segment_agg"]
    (ops.segment_agg(xg, mg) * 0.5).sum().backward()
    check(DEVICE != "cuda" or registry.launch_counts()["segment_agg"] == before + 1,
          "segment_agg's forward with a gradient did not launch the kernel")
    want = ref.segment_agg_backward(xg.detach(), mg,
                                    torch.full((7, 4, 9), 0.5, device=dev))
    check(torch.equal(xg.grad, want), "segment_agg's gradient differs from the plain backward")
    log(f"{n_checks} kernel/plain comparisons: min/max bit-exact, sum/sumsq "
        f"within {AGG_TOL}, NaN/Inf in masked slots did not leak; a gradient "
        "through the kernel's forward")


def phase_segment_agg_timing(shapes):
    """Kernel, plain and bound times at the full-width forward's shapes
    (f32, every neighbour valid, as the sampled forward calls it)."""
    log(f"== phase 5b: segment_agg times at the full-width forward's shapes ({CARD})")
    gen_t = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    for nt, d, f in shapes:
        x = torch.randn((nt, d, f), generator=gen_t, device=DEVICE)
        m = torch.ones((nt, d), dtype=torch.bool, device=DEVICE)
        got, want = ops.segment_agg(x, m), ref.segment_agg_ref(x, m)
        check(agg_close(got, want), f"segment_agg [{nt},{d},{f}] differs")
        t = {"shape": [nt, d, f],
             "max_abs_err": float((got - want).abs().max()),
             "ms": time_ms(lambda: ops.segment_agg(x, m), 20),
             "device_ms": kernel_device_ms(lambda: ops.segment_agg(x, m), 20,
                                           "segment_agg"),
             "plain_ms": time_ms(lambda: ref.segment_agg_ref(x, m), 5)}
        cost = segment_agg_cost(nt, d, f, x.element_size())
        t["bound_ms"], t["bound_by"] = bound(cost)
        log(f"segment_agg [{nt},{d},{f}] f32: {t['ms']:.4f} ms kernel "
            f"({t['device_ms']:.4f} ms on the device), "
            f"{t['plain_ms']:.4f} ms plain, {t['bound_ms']:.4f} ms bound "
            f"({t['bound_by']}, {cost[0] / 1e6:.1f} MB), "
            f"{t['ms'] / t['bound_ms']:.2f}x bound, max_abs_err "
            f"{t['max_abs_err']:.3g}")
        rows.append(t)
        del x, m, got, want
    return rows


def gnn_features(n, d_feat, n_classes, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d_feat), dtype=np.float32),
            rng.integers(0, n_classes, n))


def min_degree_core(g, k):
    """g without the edges of each vertex of fewer than k (both arcs, so
    that the graph stays undirected for the partition), repeated until every
    vertex keeps none or at least k. PNA's std is sqrt(E[x^2] - E[x]^2): at a
    vertex of one in-arc the variance is exactly 0 and its f32 gradient the
    residue of a cancellation times d std / d var = 5e5
    (tests/test_torch_train_gnn.py drops those arcs too); at a vertex of two
    whose neighbours are close in some column, the cancellation loses most
    of the variance's digits, so a rounding-level change of the inputs
    (another order of sums on the card) moves the gradient (phase 13a)."""
    src, dst = g.src, g.dst
    while True:
        deg = np.bincount(dst, minlength=g.n)
        keep = (deg[dst] >= k) & (deg[src] >= k)
        if keep.all():
            return Graph(g.n, src, dst, g.labels)
        src, dst = src[keep], dst[keep]


def logits_close(a, b):
    return torch.allclose(a.cpu(), b.cpu(), rtol=LOGIT_TOL, atol=LOGIT_TOL)


def phase_gnn_parity(shape=None):
    """Card against CPU: the sampled graphsage-reddit forward on a small
    graph, and the pattern-filtered PNA scenario of examples/pattern_gnn.py."""
    cfg, full_shape, n_classes = gnn_setup()
    shape = shape or full_shape
    log(f"== phase 5c: GNN card vs CPU ({cfg.name}, {GNN_PARITY_SEEDS} seeds; "
        f"pattern-filtered PNA)")
    g = gen.erdos_renyi_graph(GNN_PARITY_N, 20.0, seed=SEED)
    feats, labels = gnn_features(g.n, shape.d_feat, n_classes, SEED)
    out = {}
    for dev in (DEVICE, "cpu"):
        stream = SampledBatchStream(g, feats, labels, shape.fanout,
                                    GNN_PARITY_SEEDS, seed=SEED, device=dev)
        batch = stream(0)
        model = GNN(cfg, shape.d_feat, n_classes, device=dev, seed=SEED)
        logits = model.forward_sampled(batch)
        out[dev] = (batch, logits, float(model.loss(batch, logits)))
    (bc, lc, lossc), (bp, lp, lossp) = out[DEVICE], out["cpu"]
    for k in bp:
        check(torch.equal(bc[k].cpu(), bp[k]), f"sampled batch {k} differs")
    check(logits_close(lc, lp), "sampled GraphSAGE logits differ card vs CPU")
    log(f"graphsage-reddit sampled forward: batch identical, logits "
        f"{list(lc.shape)} max |card - CPU| {float((lc.cpu() - lp).abs().max()):.3g}, "
        f"loss {lossc:.6f} (CPU {lossp:.6f})")

    bg = gen.rmat_graph(11, edge_factor=8, seed=0, labeler="random", n_labels=6)
    needle = Graph.from_undirected_pairs(3, [(0, 1), (1, 2), (2, 0)], [4, 5, 3])
    gp = gen.planted_pattern_graph(bg, needle, n_copies=30, seed=2)
    template = Template([4, 5, 3], [(0, 1), (1, 2), (2, 0)])
    pna = get_arch("pna").smoke()
    runs = {}
    for dev in (DEVICE, "cpu"):
        ds = PatternFilteredDataset(gp, template, 16, 4, seed=0, device=dev)
        model = GNN(pna, 16 + template.n0, 4, device=dev, seed=0)
        logits = model(ds(0))
        runs[dev] = (ds, logits, float(model.loss(ds(0), logits)))
    (dc, lc, lossc), (dp, lp, lossp) = runs[DEVICE], runs["cpu"]
    check(dc.prune_counts == dp.prune_counts and dc.pruned.n == dp.pruned.n
          and np.array_equal(dc.pruned.src, dp.pruned.src)
          and np.array_equal(dc.pruned.dst, dp.pruned.dst)
          and np.array_equal(dc.omega, dp.omega), "pruned graph differs")
    check(logits_close(lc, lp), "pattern-filtered PNA logits differ")
    log(f"pattern-filtered PNA: background n={gp.n} m={gp.m}, pruned to "
        f"{dc.prune_counts} on both; logits max |card - CPU| "
        f"{float((lc.cpu() - lp).abs().max()):.3g}, loss {lossc:.6f} "
        f"(CPU {lossp:.6f})")


def phase_gnn_full(shape=None):
    """The GNN main path at full width, with launch counts read around it."""
    cfg, full_shape, n_classes = gnn_setup()
    shape = shape or full_shape
    n, avg_degree = shape.n_nodes, shape.n_edges / shape.n_nodes
    log(f"== phase 5d: {cfg.name} on {shape.name} (B={shape.batch_nodes}, "
        f"fanouts {shape.fanout}, d_feat {shape.d_feat}, {n_classes} classes)")
    t0 = time.perf_counter()
    g = gen.erdos_renyi_graph(n, avg_degree, seed=SEED)
    t1 = time.perf_counter()
    feats, labels = gnn_features(g.n, shape.d_feat, n_classes, SEED)
    t2 = time.perf_counter()
    stream = SampledBatchStream(g, feats, labels, shape.fanout,
                                shape.batch_nodes, seed=SEED, device=DEVICE)
    sync()
    t3 = time.perf_counter()
    log(f"background: n={g.n} m={g.m} (generated on the host in "
        f"{t1 - t0:.1f} s; features {feats.nbytes / 1e6:.0f} MB made in "
        f"{t2 - t1:.1f} s; CSR built and table staged on the device in "
        f"{t3 - t2:.1f} s)")
    del feats
    model = GNN(cfg, shape.d_feat, n_classes, device=DEVICE, seed=SEED)
    model.forward_sampled(stream(GNN_BATCHES))  # warm-up, outside the count
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    rows, first = [], None
    for step in range(GNN_BATCHES):
        ta = time.perf_counter()
        layers = stream.sample_ids(step)
        tb = time.perf_counter()
        batch = stream.gather(layers)
        sync()
        tc = time.perf_counter()
        logits = model.forward_sampled(batch)
        loss = model.loss(batch, logits)
        sync()
        td = time.perf_counter()
        lv = float(loss)
        check(logits.shape == (shape.batch_nodes, n_classes)
              and bool(torch.isfinite(logits).all()) and np.isfinite(lv),
              f"batch {step}: logits not finite or of the wrong shape")
        rows.append((tb - ta, tc - tb, td - tc, lv))
        log(f"  batch {step}: sample {tb - ta:.6f} s (host), gather "
            f"{tc - tb:.6f} s, forward+loss {td - tc:.6f} s, loss {lv:.6f}")
        if first is None:
            first = ({k: v.cpu() for k, v in batch.items()}, logits.cpu())
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    med = [float(np.median([r[i] for r in rows])) for i in range(3)]
    log(f"median per batch: sample {med[0]:.6f} s, gather {med[1]:.6f} s, "
        f"forward+loss {med[2]:.6f} s; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    check(launches["segment_agg"] == 3 * GNN_BATCHES,
          f"segment_agg launched {launches['segment_agg']} times, "
          f"expected {3 * GNN_BATCHES}")
    cpu_model = GNN(cfg, shape.d_feat, n_classes, device="cpu", seed=SEED)
    lp = cpu_model.forward_sampled(first[0])
    check(logits_close(first[1], lp), "full-width logits differ card vs CPU")
    log(f"batch 0 at full width: logits max |card - CPU| "
        f"{float((first[1] - lp).abs().max()):.3g}")
    profile_batches(stream, model, range(GNN_BATCHES, GNN_BATCHES + 3))
    return launches, stream


# the device functions each kernel's wrapper launches, as torch.profiler
# names them (bitset_spmm at W <= 2 and at W > 2; bitset_wave's worklist
# pass and hops; flash_attention's bf16 and f32 variants)
KERNEL_SYMBOLS = {
    "bitset_spmm": r"or_gather_arcs<|or_gather_warp\(",
    "bitset_wave": r"wave_worklist\(|wave_hop<",
    "segment_agg": r"segment_agg_kernel<",
    "flash_attention": r"flash_attention(_bf16)?_kernel<",
    "embedding_bag": r"embedding_bag_kernel<",
}


def device_events(prof):
    """The profiler's averages of device activity (kernels, copies)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def kernel_device_ms(fn, reps, name, per_call=1):
    """Mean device milliseconds per call of fn(), whose only device work is
    `per_call` launches of the kernel `name`: CUDA events around `reps`
    calls queued behind a device-side spin, so that the device runs them
    back to back and the host's cost between calls is hidden. (Kernel events
    of torch.profiler went missing on this machine after an earlier
    profiling session in the same process.) The kernel's launch count must
    rise by reps * per_call."""
    if DEVICE != "cuda":
        return float("nan")
    fn()
    sync()
    before = registry.launch_counts()[name]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launched = registry.launch_counts()[name] - before
    check(launched == reps * per_call,
          f"{name} launched {launched} times, not {reps * per_call}")
    if host_ms > SPIN_MS:
        log(f"  ({name}: queueing {reps} calls took {host_ms:.1f} ms, longer "
            f"than the spin: gaps may count in the device time)")
    return start.elapsed_time(stop) / reps


def profile_batches(stream, model, steps):
    """Device time by kernel and the device's busy share over whole batches
    (host sampling, gather, forward, loss)."""
    def run():
        for step in steps:
            batch = stream(step)
            model.loss(batch, model.forward_sampled(batch))
    profile_device(run, len(steps), "batch", "segment_agg")


def profile_device(fn, n, unit, kernel=None, device_ms=None):
    """Device time by kernel and the device's busy share over fn(), which
    runs n units of work, read from torch.profiler's CUDA activity. The
    profiler's own cost lands in the wall time. It checks that the profiler
    lost no events: it must have recorded as many launches of our `kernel`
    (registry name) as its wrapper counted, or, for work without one of our
    kernels, at least 80% of `device_ms` per unit (the same work's device
    time by CUDA events). Where the check fails, the busy share is reported
    as not measured. Returns the device ms per unit, or None."""
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != "cuda":
        return None
    sync()
    before = registry.launch_counts()[kernel] if kernel else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if kernel:
        launched = registry.launch_counts()[kernel] - before
        seen = sum(e.count for e in kern if re.search(KERNEL_SYMBOLS[kernel], e.key))
        lost = seen != launched
        what = f"{seen} of {launched} {kernel} launches"
    else:
        lost = busy_ms / n < 0.8 * device_ms
        what = (f"{busy_ms / n:.3f} ms of device work per {unit}, against "
                f"{device_ms:.3f} ms by CUDA events")
    if lost:
        log(f"profiler recorded {what}: it lost events, so the busy share over "
            f"{n} x {unit} is not measured")
        return None
    log(f"profiler over {n} x {unit} ({what}): wall {wall_ms / n:.3f} ms per "
        f"{unit}, device busy {busy_ms / n:.3f} ms per {unit} "
        f"({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f}% idle)")
    # the top 12, and our kernel's rows wherever they rank
    for i, e in enumerate(kern):
        if i < 12 or (kernel and re.search(KERNEL_SYMBOLS[kernel], e.key)):
            log(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/{unit} "
                f"x{e.count // n:<3d} {e.key[:90]}")
    return busy_ms / n


def graph_device_ms(fn, n):
    """Mean device milliseconds of fn()'s work: fn() captured once in a CUDA
    graph (after a warm-up call on a side stream) and the graph replayed n
    times back to back between CUDA events, so that no host time between
    launches counts. A measuring aid only: no path runs a graph. (Launches
    queued behind a device spin do not serve here: a decode step makes some
    900 launches, and the launch queue fills long before the spin ends.)"""
    if DEVICE != "cuda":
        return float("nan")
    sync()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / n


# ------------------------------------------------------------- phase 6: LM
def bf16_close(got, want, floor):
    """Elementwise |got - want| <= 2 bf16 ulps of |want| + floor (a number,
    or a tensor that broadcasts)."""
    w, g = want.float(), got.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((g - w).abs() <= 2 * ulp + floor).all())


def bf16_excess(got, want, floor):
    """max over elements of |got - want| / (2 bf16 ulps of |want| + floor),
    floor a tensor that broadcasts: the check holds where it is <= 1."""
    w, g = want.float(), got.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((g - w).abs() / (2 * ulp + floor)).max())


def attention_want(q, k, v, causal=True, window=None):
    """f32 arithmetic on the inputs, rounded once to their dtype. That is the
    plain version, except for bf16 past the blockwise cutoff, where the plain
    version rounds p to bf16 before p v: there, the blockwise version on the
    inputs widened to f32 (which rounds nothing), cast to bf16."""
    if q.dtype == torch.bfloat16 and q.shape[2] > ref.ATTENTION_BLOCKWISE_CUTOFF:
        return ref.attention_blockwise(q.float(), k.float(), v.float(), causal=causal,
                                       window=window).to(q.dtype)
    return ref.attention_plain(q, k, v, causal=causal, window=window)


def attention_weights(q, k, v, block_k, causal=True, window=None):
    """Two sums of the softmax weights p / l with |v|, [B, Hq, S, Dv] in f32,
    with p (unrounded) and l as the blockwise version at `block_k` computes
    them: A over every key, and F over the keys whose p lies within
    ATTN_P_EPS (relative) of a bf16 rounding midpoint, so that a p that
    differs from it by less than that may round the other way."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, 1)
    va = v.abs().repeat_interleave(group, 1)
    q32, scale = q.float(), 1.0 / d ** 0.5
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, hq, s), ref.ATTENTION_NEG_INF, device=q.device)
    l = torch.zeros((b, hq, s), device=q.device)
    a_all = torch.zeros((b, hq, s, v.shape[3]), device=q.device)
    a_near = torch.zeros_like(a_all)
    for k0 in range(0, s, block_k):
        k_pos = q_pos[k0:k0 + block_k]
        live = torch.ones((s, len(k_pos)), dtype=torch.bool, device=q.device)
        if causal:
            live &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            live &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.einsum("bhqd,bhkd->bhqk", q32,
                              k[:, :, k0:k0 + block_k].float()) * scale
        logits = torch.where(live, logits, ref.ATTENTION_NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        near = ((p * (1 - ATTN_P_EPS)).to(torch.bfloat16)
                != (p * (1 + ATTN_P_EPS)).to(torch.bfloat16))
        vb = va[:, :, k0:k0 + block_k].float()
        l = l * alpha + p.sum(-1)
        a_all = a_all * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        a_near = a_near * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p * near, vb)
        m = m_new
    l = l.clamp_min(1e-30)[..., None]
    return a_all / l, a_near / l


def attention_checks(got, q, k, v, causal=True, window=None):
    """(ok, {check: max |diff|, check ratio: max |diff| / allowed}) of a
    flash_attention output. f32 (the CUDA-core kernel): within ATTN_F32_TOL
    of f32 arithmetic. bf16 (the tensor-core kernel), with A and F of
    `attention_weights` at the kernel's kv tile, elementwise:
    (i) against the blockwise version at that tile on the same inputs,
    within 2 bf16 ulps + ATTN_P_FLIP F + ATTN_F32_SLACK A: the running
    maxima agree, so only a p near a rounding midpoint may round the other
    way (by one ulp, at most ATTN_P_FLIP of itself), besides the order of
    f32 sums; (ii) against f32 arithmetic rounded once, within 2 bf16 ulps +
    (ATTN_P_ROUND + 2 ATTN_P_EPS + ATTN_F32_SLACK) A: rounding p to bf16
    moves each p v by at most ATTN_P_ROUND of p |v| while l sums the
    unrounded p, and the kernel's unrounded p, in numerator and l, differs
    from exact by up to ATTN_P_EPS."""
    def diff(want):
        return float((got.float() - want.float()).abs().max())

    if got.dtype == torch.float32:
        want = attention_want(q, k, v, causal, window)
        return (torch.allclose(got, want, rtol=ATTN_F32_TOL, atol=ATTN_F32_TOL),
                {"f32": diff(want)})
    tile = ops.ATTENTION_KV_TILE[q.shape[3], v.shape[3]]
    a_all, a_near = attention_weights(q, k, v, tile, causal, window)
    ok, diffs = True, {}
    for key, want, floor in (
            ("bf16 (i)",
             lambda: ref.attention_blockwise(q, k, v, causal=causal, window=window,
                                             block_k=tile),
             ATTN_P_FLIP * a_near + ATTN_F32_SLACK * a_all),
            ("bf16 (ii)", lambda: attention_want(q, k, v, causal, window),
             (ATTN_P_ROUND + 2 * ATTN_P_EPS + ATTN_F32_SLACK) * a_all)):
        want = want()
        ratio = bf16_excess(got, want, floor)
        ok = ok and ratio <= 1.0
        diffs[key], diffs[key + " ratio"] = diff(want), ratio
        del want, floor
    return ok, diffs


ATTN_SMALL_CASES = (
    # the six cases of tests/test_kernels.py's flash_attention test
    [(1, 4, 4, 256, 128, True, None), (2, 8, 2, 256, 128, True, None),
     (1, 4, 1, 384, 128, False, None), (1, 2, 2, 512, 128, True, 128),
     (1, 2, 2, 256, 256, True, None), (3, 6, 3, 128, 128, True, 64)]
    # any S, D = 64, causal off, windows
    + [(2, 4, 2, s, 64, causal, window) for s in (1, 77, 1000)
       for causal, window in ((True, None), (False, None), (True, 33), (False, 33))]
    + [(1, 2, 1, 77, 256, True, None), (2, 3, 1, 130, 128, False, 7)])


def attention_variant_launches(fn, variant):
    """Run fn() and check that it launched flash_attention's `variant` once
    per launch of the kernel, and no other variant."""
    before = registry.variant_counts("flash_attention")
    out = fn()
    after = registry.variant_counts("flash_attention")
    if DEVICE == "cuda":
        got = {k: after[k] - before[k] for k in after}
        check(got[variant] >= 1 and sum(got.values()) == got[variant],
              f"flash_attention launched variants {got}, expected only {variant}")
    return out


def phase_attention_small():
    """flash_attention against its plain version on the card, both variants."""
    log("== phase 6a: flash_attention vs its plain version (f32: the CUDA-core "
        "kernel; bf16: the tensor-core kernel)")
    rng = np.random.default_rng(SEED)
    worst = dict.fromkeys(("f32", "bf16 (i)", "bf16 (i) ratio", "bf16 (ii)",
                           "bf16 (ii) ratio"), 0.0)
    n_checks = 0
    for b, hq, hkv, s, d, causal, window in ATTN_SMALL_CASES:
        arrays = [rng.standard_normal(shape, dtype=np.float32) * 0.3
                  for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(a).to(DEVICE).to(dtype) for a in arrays)
            got = attention_variant_launches(
                lambda: ops.attention(q, k, v, causal=causal, window=window),
                ops.attention_variant(dtype, d))
            sync()
            ok, diffs = attention_checks(got, q, k, v, causal, window)
            check(got.dtype == dtype and ok,
                  f"flash_attention [{b},{hq}/{hkv},{s},{d}] causal={causal} "
                  f"window={window} {dtype} differs: {diffs}")
            for key, val in diffs.items():
                worst[key] = max(worst[key], val)
            n_checks += 1
    # k, v as the model passes v: a [B, S, H, D] projection viewed as
    # [B, H, S, D]; each variant reads the view's strides, no copy
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((2, 4, 70, 128), device=DEVICE).to(dtype)
        v = torch.randn((2, 70, 2, 128), device=DEVICE).to(dtype).transpose(1, 2)
        got = attention_variant_launches(lambda: ops.attention(q, v, v),
                                         ops.attention_variant(dtype, 128))
        ok, diffs = attention_checks(got, q, v, v)
        check(not v.is_contiguous() and ok,
              f"flash_attention on a strided k, v view, {dtype}, differs: {diffs}")
        n_checks += 1
    log(f"{n_checks} kernel/plain comparisons within tolerance ({ATTN_TOLERANCE}): "
        f"max |diff| f32 {worst['f32']:.3g}, bf16 (i) {worst['bf16 (i)']:.3g} "
        f"({worst['bf16 (i) ratio']:.3g} of its allowance), (ii) "
        f"{worst['bf16 (ii)']:.3g} ({worst['bf16 (ii) ratio']:.3g})")


def sdpa_ms(q, k, v, reps):
    """The library row: one causal scaled_dot_product_attention call on the
    same inputs, k and v repeated to the query heads beforehand (not timed),
    on the fused backend (cuDNN, flash or memory-efficient) that SDPA picks
    by its default order; its math backend, which would materialise the
    [S, S] logits, is left out. None where no fused backend takes the
    inputs. Timed here only; the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    try:
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            return time_ms(lambda: F.scaled_dot_product_attention(
                q, ke, ve, is_causal=True), reps)
    except RuntimeError as e:
        log(f"  (SDPA takes no fused backend for {list(q.shape)} / {list(v.shape)}: "
            f"{str(e).splitlines()[0][:200]})")
        return None


def ptxas_report(kernel):
    """ptxas's register and spill lines for the entry functions whose
    mangled names hold `kernel`, from the build log: [(function, line)]."""
    rows, fn = [], None
    for line in build.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and kernel in fn and ("registers" in line or "spill" in line):
            rows.append((fn, line.split(":", 1)[-1].strip()))
    return rows


def phase_attention_timing(shapes):
    """Kernel, plain, library and bound times at the LM path's shapes (bf16,
    causal, the tensor-core kernel): the prefill of one prefill_32k sequence
    and the serving prefill."""
    log(f"== phase 6b: flash_attention times at the LM path's shapes ({CARD})")
    for fn, line in ptxas_report("flash_attention_bf16_kernel"):
        log(f"  ptxas {fn}: {line}")
    rows = []
    for b, hq, hkv, s, d, reps in shapes:
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        q, k, v = (torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        got = attention_variant_launches(lambda: ops.attention(q, k, v), "bf16_tc")
        ok, diffs = attention_checks(got, q, k, v)
        check(ok, f"flash_attention [{b},{hq},{s},{d}] differs: {diffs}")
        t = {"shape": [b, hq, hkv, s, d], "dtype": "bfloat16", "variant": "bf16_tc",
             "max_abs_err": diffs["bf16 (ii)"], "max_abs_err_tile": diffs["bf16 (i)"],
             "allowance_used": [diffs["bf16 (i) ratio"], diffs["bf16 (ii) ratio"]]}
        del got
        t["ms"] = time_ms(lambda: ops.attention(q, k, v), reps)
        t["device_ms"] = kernel_device_ms(lambda: ops.attention(q, k, v), reps,
                                          "flash_attention")
        t["plain_ms"] = time_ms(lambda: ref.attention_plain(q, k, v), 1)
        t["library_ms"] = sdpa_ms(q, k, v, reps)
        cost = attention_cost(b, hq, hkv, s, d, 2)
        t["bound_ms"], t["bound_by"] = bound(cost, PEAK_BF16_FLOPS_PER_S)
        log(f"flash_attention [{b},{hq}/{hkv},{s},{d}] bf16 causal: {t['ms']:.4f} ms "
            f"kernel ({t['device_ms']:.4f} ms on the device, "
            f"{cost[1] / t['device_ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['device_ms'] / t['bound_ms']:.2f}x bound, "
            f"{t['device_ms'] / t['library_ms']:.2f}x SDPA), {t['plain_ms']:.4f} ms "
            f"plain, {t['library_ms']:.4f} ms SDPA, {t['bound_ms']:.4f} ms bound "
            f"({t['bound_by']}: {cost[1] / 1e12:.3f} TFLOP, {cost[0] / 1e6:.1f} MB); "
            f"max |diff| (i) {diffs['bf16 (i)']:.3g} ({diffs['bf16 (i) ratio']:.3g} "
            f"of its allowance), (ii) {diffs['bf16 (ii)']:.3g} "
            f"({diffs['bf16 (ii) ratio']:.3g})")
        rows.append(t)
        del q, k, v
    return rows


def phase_lm_parity(n_layers=LM_PARITY_LAYERS, batch=LM_PARITY_BATCH,
                    prompt_len=LM_PARITY_LEN, new=LM_PARITY_NEW, cfg=None):
    """Card against CPU: qwen2-1.5b at full width, cut to n_layers, in f32,
    the same weights on both; prefill logits and greedy tokens."""
    cfg = dataclasses.replace(cfg or get_arch(LM_ARCH).CONFIG, n_layers=n_layers,
                              dtype="float32")
    log(f"== phase 6c: {cfg.name} card vs CPU ({n_layers} layers, f32, "
        f"B={batch}, S={prompt_len}, {new} greedy tokens)")
    cpu = Transformer(cfg, device="cpu", seed=SEED)
    card = copy.deepcopy(cpu).to(DEVICE)
    prompt = SyntheticTokenStream(cfg.vocab, batch, prompt_len, seed=SEED,
                                  device="cpu")(0)["tokens"]
    out = {}
    registry.reset_launches()
    for dev, model in ((DEVICE, card), ("cpu", cpu)):
        t0 = time.perf_counter()
        _, logits = build_prefill(model)(prompt.to(dev), prompt_len + new)
        toks = greedy_generate(model, prompt.to(dev), new, prompt_len + new)
        sync()
        out[dev] = (logits.cpu(), toks.cpu(), time.perf_counter() - t0)
    (lc, tc, sc), (lp, tp, sp) = out[DEVICE], out["cpu"]
    if DEVICE == "cuda":
        check(registry.launch_counts()["flash_attention"] == 2 * n_layers,
              "the card's prefills did not run through flash_attention")
    diff = float((lc - lp).abs().max())
    check(torch.allclose(lc, lp, rtol=LM_PARITY_TOL, atol=LM_PARITY_TOL),
          f"prefill logits differ card vs CPU by {diff:.3g}")
    check(torch.equal(tc, tp), f"greedy tokens differ: {tc.tolist()} vs {tp.tolist()}")
    log(f"last logits [{batch}, {cfg.vocab}] max |card - CPU| {diff:.3g} "
        f"(tolerance {LM_PARITY_TOL}); {new} greedy tokens equal: {tc[0].tolist()}; "
        f"card {sc:.2f} s, CPU {sp:.2f} s")


def phase_lm_full(cfg=None, prefill_len=None, serve=None):
    """The LM path at full width: the prefill_32k program on one sequence,
    then greedy serving, with launch counts read around each."""
    cfg = cfg or get_arch(LM_ARCH).CONFIG
    prefill_len = prefill_len or get_arch(LM_ARCH).SHAPES[LM_PREFILL_SHAPE].seq_len
    b, p, new = serve or (LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_NEW)
    log(f"== phase 6d: {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype})")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=DEVICE, seed=SEED)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in model.params.values())
    log(f"random weights made on the device in {time.perf_counter() - t0:.2f} s: "
        f"{cfg.n_params()} parameters (+ biases), {n_bytes / 1e9:.3f} GB")
    res = {}

    # (i) prefill_32k: forward_hidden + last-position logits, one sequence
    toks = SyntheticTokenStream(cfg.vocab, 1, prefill_len, seed=SEED,
                                device=DEVICE)(0)["tokens"]
    model.forward_hidden(toks[:, :256])   # warm-up, outside the count (-> h, aux)
    sync()
    reset_peak()
    registry.reset_launches()
    t0 = time.perf_counter()
    h, _ = model.forward_hidden(toks)
    logits = model.logits_from_hidden(h[:, -1:])[:, 0]
    sync()
    res["prefill_32k_s"] = time.perf_counter() - t0
    res["prefill_32k_launches"] = registry.launch_counts()["flash_attention"]
    res["prefill_32k_variants"] = registry.variant_counts("flash_attention")
    res["prefill_32k_peak_gib"] = peak_gib()
    check(logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "prefill_32k logits not finite or of the wrong shape")
    check(DEVICE != "cuda" or res["prefill_32k_launches"] == cfg.n_layers,
          f"prefill_32k launched flash_attention {res['prefill_32k_launches']} "
          f"times, expected {cfg.n_layers}")
    check(DEVICE != "cuda" or cfg.dtype != "bfloat16"
          or res["prefill_32k_variants"]["bf16_tc"] == cfg.n_layers,
          f"prefill_32k's launches by variant {res['prefill_32k_variants']}: "
          f"all {cfg.n_layers} must be the tensor-core kernel")
    log(f"(i) prefill_32k, 1 x {prefill_len} tokens (global_batch 32 cut to 1): "
        f"{res['prefill_32k_s']:.3f} s, {prefill_len / res['prefill_32k_s']:.0f} "
        f"tokens/s, flash_attention launches {res['prefill_32k_launches']} "
        f"({res['prefill_32k_variants']}), "
        f"max_memory_allocated {res['prefill_32k_peak_gib']:.3f} GiB")
    del h, logits, toks

    # (ii) serving: greedy generation for b requests of p-token prompts
    prompts = SyntheticTokenStream(cfg.vocab, b, p, seed=SEED + 1,
                                   device=DEVICE)(0)["tokens"]
    greedy_generate(model, prompts[:, :64], 2, 66)   # warm-up, outside the count
    sync()
    reset_peak()
    registry.reset_launches()
    t0 = time.perf_counter()
    out = greedy_generate(model, prompts, new, p + new)
    sync()
    res["serve_s"] = time.perf_counter() - t0
    launches = registry.launch_counts()
    res["serve_variants"] = registry.variant_counts("flash_attention")
    res["serve_peak_gib"] = peak_gib()
    check(out.shape == (b, new) and bool(((out >= 0) & (out < cfg.vocab)).all()),
          "generated tokens of the wrong shape or out of the vocabulary")
    check(DEVICE != "cuda" or launches["flash_attention"] == cfg.n_layers,
          f"serving launched flash_attention {launches['flash_attention']} times, "
          f"expected {cfg.n_layers} (one prefill)")
    check(DEVICE != "cuda" or cfg.dtype != "bfloat16"
          or res["serve_variants"]["bf16_tc"] == cfg.n_layers,
          f"serving's launches by variant {res['serve_variants']}: all must be "
          "the tensor-core kernel")
    # the same requests step by step, for the split of prefill and decode
    t0 = time.perf_counter()
    cache, logits = build_prefill(model)(prompts, p + new)
    sync()
    res["serve_prefill_s"] = time.perf_counter() - t0
    step = build_decode_step(model)
    tok = logits.argmax(-1).to(torch.int32)
    toks, step_s = [tok], []
    for _ in range(new - 1):
        t0 = time.perf_counter()
        tok, _, cache = step(cache, tok)
        sync()
        step_s.append(time.perf_counter() - t0)
        toks.append(tok)
    check(torch.equal(torch.stack(toks, 1), out), "step-by-step tokens differ")
    res["decode_ms_median"] = float(np.median(step_s)) * 1e3
    res["serve_tokens_per_s"] = b * new / res["serve_s"]
    log(f"(ii) serving {b} requests x {p}-token prompts, {new} new tokens "
        f"(decode_32k's batch 128 cut to {b}): {res['serve_s']:.3f} s end to end, "
        f"{res['serve_tokens_per_s']:.1f} generated tokens/s; prefill "
        f"{res['serve_prefill_s']:.3f} s, decode {res['decode_ms_median']:.3f} ms "
        f"per token (median of {len(step_s)}); flash_attention launches "
        f"{launches['flash_attention']}; max_memory_allocated "
        f"{res['serve_peak_gib']:.3f} GiB; first tokens {out[0, :8].tolist()}")
    del cache

    # (iii) device time of a decode step alone, and the device's busy share
    # over a serving prefill and over decode steps alone
    cache, logits = build_prefill(model)(prompts, p + 4 + LM_DECODE_PROFILED)
    tok = [logits.argmax(-1).to(torch.int32)]

    def decode():
        tok[0], _, _ = step(cache, tok[0])
    decode()
    res["decode_device_ms"] = graph_device_ms(decode, LM_DECODE_TIMED)
    res["decode_busy_share"] = res["decode_device_ms"] / res["decode_ms_median"]
    log(f"(iii) decode step on the device: {res['decode_device_ms']:.4f} ms "
        f"(CUDA events over {LM_DECODE_TIMED} replays of the step captured in "
        f"a CUDA graph), {100 * res['decode_busy_share']:.1f}% of the "
        f"{res['decode_ms_median']:.3f} ms per token of (ii)")

    def decode_window():
        for _ in range(LM_DECODE_PROFILED):
            decode()
    res["decode_profiled_device_ms"] = profile_device(
        decode_window, LM_DECODE_PROFILED, "decode step",
        device_ms=res["decode_device_ms"])
    del cache
    profile_device(lambda: build_prefill(model)(prompts, p + new), 1,
                   "serving prefill", "flash_attention")
    return launches, res


def phase_serve_cli(label, arch):
    """The serving CLI (`launch/serve.py --arch`) on the device, with its
    own config and sizes."""
    log(f"== phase {label}: the serving CLI, --arch {arch} --device {DEVICE}")
    cfg = serve_cli.serve_config(arch)
    before = registry.launch_counts()["flash_attention"]
    out = serve_cli.main(["--arch", arch, "--device", DEVICE])
    sync()
    launched = registry.launch_counts()["flash_attention"] - before
    if isinstance(cfg, LMConfig):
        check(out.ndim == 2 and bool(((out >= 0) & (out < cfg.vocab)).all()),
              "the CLI's tokens are out of the vocabulary")
        check(DEVICE != "cuda" or launched == cfg.n_layers,
              f"the CLI's prefill launched flash_attention {launched} times")
    else:
        check(out.shape[1] == 10 and bool(((out >= 0) & (out < cfg.n_items + 2)).all()),
              "the CLI's top-10 is out of the catalog")


# --------------------------------------------------------- phase 7: recsys
BAG_SMALL_CASES = (
    # the four cases of tests/test_kernels.py's embedding_bag test
    [(1000, 128, 8, 4, "sum"), (5000, 256, 16, 10, "mean"),
     (128, 128, 4, 1, "sum"), (2048, 512, 2, 32, "mean")]
    + [(1000, d, 37, l, mode) for l in (1, 4, 32) for d in (32, 64, 128, 602)
       for mode in ("sum", "mean")])


def bag_close(got, want):
    """f32: within BAG_TOL. bf16: within 2 bf16 ulps plus 1e-6 (f32 sums of
    the same products in another order, rounded once)."""
    if got.dtype == torch.float32:
        return torch.allclose(got, want, rtol=BAG_TOL, atol=BAG_TOL)
    return bf16_close(got, want, 1e-6)


def phase_embedding_bag_small():
    """embedding_bag against its plain version on the card."""
    log("== phase 7a: embedding_bag vs its plain version")
    rng = np.random.default_rng(SEED)
    n_checks = 0
    for v, d, b, l, mode in BAG_SMALL_CASES:
        table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32))
        ids = torch.from_numpy(rng.integers(0, v, (b, l)).astype(np.int32))
        weights = torch.from_numpy((rng.random((b, l)) < 0.9).astype(np.float32))
        weights[0] = 0.0                           # an all-padding bag
        if l > 1:
            weights[1] *= 2.5                      # real-valued weights
        for dtype in (torch.float32, torch.bfloat16):
            args = (table.to(DEVICE).to(dtype), ids.to(DEVICE), weights.to(DEVICE))
            got = ops.embedding_bag(*args, mode=mode)
            want = ref.embedding_bag_ref(*args, mode=mode)
            sync()
            check(got.dtype == dtype and bag_close(got, want),
                  f"embedding_bag V={v} D={d} B={b} L={l} {mode} {dtype} differs")
            n_checks += 1
    # ids as jnp.take reads them (negative from the end, outside [-V, V) NaN),
    # on a table whose base is not aligned to a vector load
    table = torch.randn((6 * 64 + 1,), device=DEVICE).to(torch.bfloat16)[1:].view(6, 64)
    ids = torch.tensor([[-1, 0], [2, 6], [-7, 1], [5, 5]], dtype=torch.int32,
                       device=DEVICE)
    got, want = ops.embedding_bag(table, ids), ref.embedding_bag_ref(
        table, ids, torch.ones(ids.shape, device=DEVICE))
    check(torch.equal(got[[0, 3]], want[[0, 3]]) and bool(got[1:3].isnan().all())
          and bool(want[1:3].isnan().all()),
          "embedding_bag on negative / out-of-range ids or an unaligned table differs")
    n_checks += 1
    log(f"{n_checks} kernel/plain comparisons within tolerance (f32 rtol = atol = "
        f"{BAG_TOL}, bf16 2 ulps + 1e-6)")


def phase_embedding_bag_timing(n_rows, d, n_cand):
    """Kernel, plain, library and bound times at the retrieval_cand shape:
    n_cand bags of one id (a permutation of the item ids) over the bf16 item
    table, weights 1."""
    log(f"== phase 7b: embedding_bag times at the retrieval_cand shape "
        f"({n_cand} bags of 1 over [{n_rows}, {d}] bf16; {CARD})")
    import torch.nn.functional as F

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    table = torch.randn((n_rows, d), generator=g, device=DEVICE).to(torch.bfloat16)
    ids = (torch.randperm(n_cand, generator=g, device=DEVICE) + 1).to(torch.int32)[:, None]
    w = torch.ones(ids.shape, device=DEVICE)
    got, want = ops.embedding_bag(table, ids, w), ref.embedding_bag_ref(table, ids, w)
    check(torch.equal(got, want), "embedding_bag at the retrieval shape differs")
    t = {"shape": [n_rows, d, n_cand, 1], "dtype": "bfloat16",
         "max_abs_err": float((got.float() - want.float()).abs().max()),
         "ms": time_ms(lambda: ops.embedding_bag(table, ids, w), 20),
         "device_ms": kernel_device_ms(lambda: ops.embedding_bag(table, ids, w), 20,
                                       "embedding_bag"),
         "plain_ms": time_ms(lambda: ref.embedding_bag_ref(table, ids, w), 5)}
    ids64, w16 = ids.long(), w.to(table.dtype)
    t["library_ms"] = time_ms(lambda: F.embedding_bag(
        ids64, table, per_sample_weights=w16, mode="sum"), 20)
    rows = int(torch.unique(ids).numel())
    cost = embedding_bag_cost(n_cand, 1, d, table.element_size(), rows)
    t["bound_ms"], t["bound_by"] = bound(cost)
    log(f"embedding_bag: {t['ms']:.4f} ms kernel ({t['device_ms']:.4f} ms on the "
        f"device), {t['plain_ms']:.4f} ms plain, {t['library_ms']:.4f} ms "
        f"F.embedding_bag, {t['bound_ms']:.4f} ms bound ({t['bound_by']}, "
        f"{cost[0] / 1e6:.1f} MB), {t['device_ms'] / t['bound_ms']:.2f}x "
        f"bound; bit-exact with the plain version")
    return t


def phase_recsys_parity(n_users=8):
    """Card against CPU: the bert4rec smoke config in f32, the same weights on
    both; catalog scores and retrieval scores over every item."""
    cfg = get_arch(RECSYS_ARCH).smoke()
    log(f"== phase 7c: {cfg.name} card vs CPU ({n_users} users, f32)")
    cpu = Bert4Rec(cfg, device="cpu", seed=SEED)
    card = copy.deepcopy(cpu).to(DEVICE)
    items = MaskedSequenceStream(cfg.n_items, n_users, cfg.seq_len, seed=SEED,
                                 device="cpu")(0)["items"]
    cands = torch.arange(1, cfg.n_items + 1, dtype=torch.int32)
    registry.reset_launches()
    out = {}
    for dev, model in ((DEVICE, card), ("cpu", cpu)):
        out[dev] = (model.serve_scores(items.to(dev)).cpu(),
                    model.retrieval_scores(items.to(dev), cands.to(dev)).cpu())
    if DEVICE == "cuda":
        check(registry.launch_counts()["embedding_bag"] == 1,
              "the card's retrieval did not run through embedding_bag")
    for name, a, b in (("serve", out[DEVICE][0], out["cpu"][0]),
                       ("retrieval", out[DEVICE][1], out["cpu"][1])):
        check(logits_close(a, b), f"{name} scores differ card vs CPU")
        log(f"{name} scores {list(a.shape)}: max |card - CPU| "
            f"{float((a - b).abs().max()):.3g}")


def phase_recsys_full(cfg=None, serve_batch=None, n_cand=None):
    """The recsys path at full width: serve_p99 (catalog scores + top-10) and
    retrieval_cand (one user against every item), launches read around
    each."""
    cfg = cfg or get_arch(RECSYS_ARCH).CONFIG
    shapes = get_arch(RECSYS_ARCH).SHAPES
    serve_batch = serve_batch or shapes["serve_p99"].batch
    n_cand = n_cand or shapes["retrieval_cand"].n_candidates
    log(f"== phase 7d: {cfg.name} at full width (embed {cfg.embed_dim}, "
        f"{cfg.n_blocks} blocks, {cfg.n_heads} heads, seq {cfg.seq_len}, "
        f"{cfg.n_items} items, {cfg.dtype}); serve_bulk (262,144 x "
        f"{cfg.n_items + 2} logits) does not fit and is cut")
    model = Bert4Rec(cfg, device=DEVICE, seed=SEED)
    items = MaskedSequenceStream(cfg.n_items, serve_batch, cfg.seq_len, seed=SEED,
                                 device=DEVICE)(0)["items"]
    res = {}

    def serve():
        return torch.topk(model.serve_scores(items), 10).indices

    serve()                                   # warm-up
    sync()
    reset_peak()
    registry.reset_launches()
    t0 = time.perf_counter()
    top = serve()
    sync()
    res["serve_p99_s"] = time.perf_counter() - t0
    res["serve_p99_peak_gib"] = peak_gib()
    check(top.shape == (serve_batch, 10) and bool((top >= 0).all()),
          "serve_p99 top-10 of the wrong shape")
    log(f"serve_p99: {serve_batch} users -> top-10 of {cfg.n_items + 2} items in "
        f"{res['serve_p99_s'] * 1e3:.3f} ms; launches {registry.launch_counts()}; "
        f"max_memory_allocated {res['serve_p99_peak_gib']:.3f} GiB")

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    cands = (torch.randperm(n_cand, generator=g, device=DEVICE) + 1).to(torch.int32)
    user = items[:1]
    model.retrieval_scores(user, cands)       # warm-up
    sync()
    reset_peak()
    registry.reset_launches()
    t0 = time.perf_counter()
    scores = model.retrieval_scores(user, cands)
    sync()
    res["retrieval_s"] = time.perf_counter() - t0
    launches = registry.launch_counts()
    res["retrieval_peak_gib"] = peak_gib()
    check(DEVICE != "cuda" or launches["embedding_bag"] == 1,
          f"retrieval launched embedding_bag {launches['embedding_bag']} times, expected 1")
    h = model.encode(user)[:, -1].float()
    table, bias = model.params["items"], model.params["out_bias"]
    want = h @ table[cands.long()].float().T + bias[cands.long()].float()
    check(scores.shape == (1, n_cand) and bool(torch.isfinite(scores).all())
          and torch.allclose(scores, want, rtol=1e-5, atol=1e-5),
          "retrieval scores differ from a plain gather of the candidates")
    log(f"retrieval_cand: 1 user x {n_cand} candidates in "
        f"{res['retrieval_s'] * 1e3:.3f} ms; embedding_bag launches "
        f"{launches['embedding_bag']}; max_memory_allocated "
        f"{res['retrieval_peak_gib']:.3f} GiB; scores equal a plain gather")
    return launches, res


# ------------------------------------------------------- phase 11: training
# 11a: card against CPU at smoke size, TRAIN_STEPS steps from one state on
# each device (f32; the LM at head dim 64, the least flash_attention takes)
TRAIN_STEPS = 3
TRAIN_LOSS_TOL = 1e-4    # losses card vs CPU, relative: f32 in another order
# parameters card vs CPU after the steps, absolute. A gradient entry within
# rounding of 0 (or, with compressed gradients, an int8 value at a .5
# boundary) may take either sign or value on the two devices, and AdamW
# turns it into a step of up to lr of either sign: at most
# TRAIN_FLIP_SHARE of a leaf's entries may differ by more, by at most
# lr a step.
TRAIN_PARAM_TOL = 1e-4
TRAIN_FLIP_SHARE = 1e-3
TRAIN_OPT = dict(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
# 11b: the plain backwards, held to autograd through the plain forwards on
# the card. segment_agg f32: sums of at most four terms in another order;
# bf16: both round an f32 value once (2 ulps + AGG_BWD_TOL). flash_attention
# bf16: the plain backward and autograd through `ref.attention_ref` on the
# inputs in f32 compute the same f32 function in another order, each cast
# to bf16 once: 2 bf16 ulps + ATTN_BWD_FLOOR x the largest |gradient|.
AGG_BWD_TOL = 1e-5
ATTN_BWD_FLOOR = 2.0 ** -12
# (B, Hq, Hkv, S, D, timed calls): one train_4k sequence, and 8 x 2048
ATTN_BWD_SHAPES = [(1, 12, 2, 4096, 128, 3), (8, 12, 2, 2048, 128, 3)]
# 11c: graphsage-reddit on minibatch_lg, 10 AdamW steps on 5d's stream
GNN_TRAIN_STEPS = 10
# 11d: qwen2-1.5b at full width on train_4k, global_batch 256 cut to 2 = 2
# microbatches of 1 x 4096 tokens, full remat, bf16 parameters, f32 moments
LM_TRAIN_SHAPE, LM_TRAIN_BATCH, LM_TRAIN_MICRO, LM_TRAIN_STEPS = "train_4k", 2, 2, 3
# 11e: bert4rec at full width, train_batch 65,536 cut to 8 users x 200
RECSYS_TRAIN_USERS, RECSYS_TRAIN_STEPS = 8, 3
# 11f: the trainer restart, a failure at step 3 of 6, checkpoints every 2
RESTART_STEPS, RESTART_FAIL_AT, RESTART_INTERVAL = 6, 3, 2

def train_tc(**kw):
    return TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT), warmup_steps=1,
                       total_steps=10, **kw)


def params_diff(a, b, steps, lr):
    """(max |a - b| over the entries within TRAIN_PARAM_TOL, entries beyond
    it, the largest difference); checks TRAIN_FLIP_SHARE and lr a step."""
    close, flips, top = 0.0, 0, 0.0
    for x, y in zip(leaves(a), leaves(b)):
        d = (x.float().cpu() - y.float().cpu()).abs()
        over = d > TRAIN_PARAM_TOL
        check(float(over.float().mean()) <= TRAIN_FLIP_SHARE,
              f"{int(over.sum())} of {d.numel()} entries of a leaf differ by more "
              f"than {TRAIN_PARAM_TOL}")
        flips += int(over.sum())
        top = max(top, float(d.max()))
        close = max(close, float(d[~over].max()) if (~over).any() else 0.0)
    check(top <= steps * lr, f"parameters differ by {top:.3g}")
    return close, flips, top


def train_card_vs_cpu(name, model, tc, batch_at, steps=TRAIN_STEPS, kernel=None):
    """`steps` train steps of `model` (on the CPU) and of a copy on the card
    from the same state; batch_at(step, device) gives each step's batch.
    Losses within TRAIN_LOSS_TOL, parameters within TRAIN_PARAM_TOL, and
    `kernel`, where given, launched on the card."""
    card = copy.deepcopy(model).to(DEVICE)
    runs = {}
    registry.reset_launches()
    for dev, m in ((DEVICE, card), ("cpu", model)):
        state, step = init_train_state(m, tc), build_train_step(m, tc)
        t0 = time.perf_counter()
        losses = []
        for i in range(steps):
            state, met = step(state, batch_at(i, dev))
            losses.append(float(met["loss"]))
        runs[dev] = (losses, state, time.perf_counter() - t0)
        if dev == DEVICE:
            launches = registry.launch_counts()
    (lc, sc, tcard), (lp, sp, tcpu) = runs[DEVICE], runs["cpu"]
    check(np.allclose(lc, lp, rtol=TRAIN_LOSS_TOL, atol=0),
          f"{name}: losses differ card vs CPU: {lc} vs {lp}")
    diff, flips, top = params_diff(sc["params"], sp["params"], steps, tc.optimizer.lr)
    if kernel and DEVICE == "cuda":
        check(launches[kernel] > 0, f"{name}: {kernel} was not launched on the card")
    log(f"  {name}: losses {[round(x, 6) for x in lc]} (CPU "
        f"{[round(x, 6) for x in lp]}), parameters max |card - CPU| {diff:.3g}"
        f"{f' ({flips} entries by up to {top:.3g})' if flips else ''}, "
        f"card {tcard:.2f} s, CPU {tcpu:.2f} s"
        + (f", {kernel} launches {launches[kernel]}" if kernel else ""))
    return launches


def sampled_train_batch(step, dev, b=16, f1=5, f2=3, d=24, n_classes=5):
    """A sampled GraphSAGE batch with padding masks, from numpy."""
    rng = np.random.default_rng(SEED + step)
    batch = {"x_self": rng.standard_normal((b, d), dtype=np.float32),
             "x_nbr": rng.standard_normal((b, f1, d), dtype=np.float32),
             "x_nbr2": rng.standard_normal((b, f1, f2, d), dtype=np.float32),
             "labels": rng.integers(0, n_classes, b),
             "m_nbr": rng.random((b, f1)) < 0.7,
             "m_nbr2": rng.random((b, f1, f2)) < 0.7}
    batch["m_nbr"][0] = False
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def phase_train_parity():
    """11a: the training path card against CPU at smoke size."""
    log("== phase 11a: training, card vs CPU at smoke size "
        f"({TRAIN_STEPS} steps from one state; losses rtol {TRAIN_LOSS_TOL}, "
        f"parameters atol {TRAIN_PARAM_TOL})")
    g = gen.erdos_renyi_graph(300, 5.0, seed=SEED, n_labels=4)
    # PNA's graph keeps no vertex of one in-arc, whose variance tie makes its
    # gradient run-to-run noise on the card (min_degree_core)
    graphs = {"pna": min_degree_core(g, 2)}
    for arch in ("pna", "graphsage-reddit", "gin-tu", "gat-cora"):
        graph_batch = {dev: full_graph_batch(graphs.get(arch, g), 16, 4, seed=SEED,
                                             device=dev) for dev in (DEVICE, "cpu")}
        model = GNN(get_arch(arch).smoke(), 16, 4, device="cpu", seed=SEED)
        train_card_vs_cpu(f"{arch} smoke, full graph"
                          + (" (no degree-one vertex)" if arch in graphs else ""),
                          model, train_tc(), lambda i, dev: graph_batch[dev])
    model = GNN(get_arch("graphsage-reddit").smoke(), 24, 5, device="cpu", seed=SEED)
    agg = train_card_vs_cpu("graphsage-reddit smoke, sampled batches", model,
                            train_tc(), sampled_train_batch, kernel="segment_agg")
    check(DEVICE != "cuda" or agg["segment_agg"] == 3 * TRAIN_STEPS,
          f"sampled training launched segment_agg {agg['segment_agg']} times")
    gp, template = pattern_gnn.scenario()
    datasets = {dev: PatternFilteredDataset(gp, template, pattern_gnn.D_FEAT,
                                            pattern_gnn.N_CLASSES, seed=0, device=dev)
                for dev in (DEVICE, "cpu")}
    check(datasets[DEVICE].prune_counts == datasets["cpu"].prune_counts,
          "pattern-filtered prune differs card vs CPU")
    model = GNN(get_arch("pna").smoke(), pattern_gnn.D_FEAT + template.n0,
                pattern_gnn.N_CLASSES, device="cpu", seed=0)
    train_card_vs_cpu("pattern-filtered PNA (examples/pattern_gnn.py)", model,
                      TrainConfig(optimizer=AdamWConfig(lr=5e-3, weight_decay=0.0)),
                      lambda i, dev: datasets[dev](i), steps=5)
    lm_cfg = serve_cli.serve_config(LM_ARCH)
    for label, cfg_kw, tc_kw in (
            ("plain CE", {}, {}), ("fused_ce=48", {"fused_ce": 48}, {}),
            ("remat=True", {}, {"remat": True}), ('remat="dots"', {}, {"remat": "dots"}),
            ("2 microbatches", {}, {"microbatches": 2}),
            ("compressed gradients", {}, {"compress_grads": True})):
        cfg = dataclasses.replace(lm_cfg, **cfg_kw)
        streams = {dev: SyntheticTokenStream(cfg.vocab, 4, 64, seed=SEED, device=dev)
                   for dev in (DEVICE, "cpu")}
        train_card_vs_cpu(f"{cfg.name} (head dim {cfg.hd}), {label}",
                          Transformer(cfg, device="cpu", seed=SEED), train_tc(**tc_kw),
                          lambda i, dev: streams[dev](i), kernel="flash_attention")
    rec_cfg = get_arch(RECSYS_ARCH).smoke()
    for label, kw in (("full softmax", {}), ("fused_ce=96", {"fused_ce": 96}),
                      ("40 sampled negatives", {"n_negatives": 40})):
        cfg = dataclasses.replace(rec_cfg, **kw)
        streams = {dev: MaskedSequenceStream(cfg.n_items, 6, cfg.seq_len, seed=SEED,
                                             device=dev) for dev in (DEVICE, "cpu")}
        train_card_vs_cpu(f"{cfg.name}, {label}", Bert4Rec(cfg, device="cpu", seed=SEED),
                          train_tc(), lambda i, dev: streams[dev](i))
    log("== phase 11a: python -m repro_torch.launch.pattern_gnn")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.pattern_gnn", "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    log(proc.stdout.strip())
    check(proc.returncode == 0 and proc.stdout.strip().endswith("OK")
          and f"({DEVICE}" in proc.stdout,
          f"launch.pattern_gnn failed ({proc.returncode}): {proc.stderr[-2000:]}")
    log(f"launch.pattern_gnn exited 0 in {time.perf_counter() - t0:.1f} s")


def phase_segment_agg_backward(shapes):
    """11b: segment_agg's gradient through its autograd Function (the kernel
    forward, the plain backward) against autograd through the plain forward
    on the card, with tied minima and maxima; the plain backward's times."""
    log(f"== phase 11b: segment_agg backward vs autograd of the plain forward ({CARD})")
    gen_t = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    for nt, d, f in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            # quarters: minima and maxima tie within rows
            x = (torch.randn((nt, d, f), generator=gen_t, device=DEVICE) * 4).round() / 4
            x = x.to(dtype)
            m = torch.rand((nt, d), generator=gen_t, device=DEVICE) < 0.8
            m[0] = False
            g = torch.randn((nt, 4, f), generator=gen_t, device=DEVICE)
            xg = x.clone().requires_grad_(True)
            before = registry.launch_counts()["segment_agg"]
            ops.segment_agg(xg, m).backward(g)
            sync()
            check(DEVICE != "cuda"
                  or registry.launch_counts()["segment_agg"] == before + 1,
                  "the forward of the gradient did not launch segment_agg")
            xr = x.clone().requires_grad_(True)
            ref.segment_agg_ref(xr, m).backward(g)
            got, want = xg.grad, xr.grad
            err = float((got.float() - want.float()).abs().max())
            ok = (torch.allclose(got, want, rtol=AGG_BWD_TOL, atol=AGG_BWD_TOL)
                  if dtype == torch.float32 else bf16_close(got, want, AGG_BWD_TOL))
            check(ok, f"segment_agg backward [{nt},{d},{f}] {dtype} differs by {err:.3g}")
            del xg, xr, got, want
            t = {"shape": [nt, d, f], "dtype": str(dtype).split(".")[1],
                 "max_abs_err": err,
                 "ms": time_ms(lambda: ref.segment_agg_backward(x, m, g), 10),
                 "library_ms": None}
            cost = segment_agg_backward_cost(nt, d, f, x.element_size())
            t["bound_ms"], t["bound_by"] = bound(cost)
            log(f"segment_agg backward (plain) [{nt},{d},{f}] {t['dtype']}: "
                f"{t['ms']:.4f} ms, {t['bound_ms']:.4f} ms bound ({t['bound_by']}, "
                f"{cost[0] / 1e6:.1f} MB), {t['ms'] / t['bound_ms']:.2f}x bound; "
                f"max |diff| vs autograd {err:.3g}")
            rows.append(t)
            del x, m, g
    return rows


def sdpa_backward_ms(q, k, v, do, reps):
    """The library row: the backward of one causal scaled_dot_product_attention
    call (autograd) on the same inputs, k and v repeated to the query heads
    beforehand. Timed here only; no path of the port runs SDPA."""
    import torch.nn.functional as F

    group = q.shape[1] // k.shape[1]
    qs = q.detach().requires_grad_(True)
    ks = k.repeat_interleave(group, 1).requires_grad_(True)
    vs = v.repeat_interleave(group, 1).requires_grad_(True)
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    return time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                               retain_graph=True), reps)


def phase_attention_backward(shapes, phase="11b"):
    """11b: flash_attention's gradient through its autograd Function (the
    bf16 tensor-core forward, the plain backward) against autograd through
    `ref.attention_ref` on the inputs in f32, on the card, and the forward's
    output held to the plain version as in 6b (the plain backward recomputes
    from q, k and v and never reads it); the plain backward's times beside
    2.5x the forward's operations at the bf16 peak and SDPA's autograd
    backward."""
    log(f"== phase {phase}: flash_attention backward vs f32 autograd of the plain "
        f"forward ({CARD})")
    rows = []
    for b, hq, hkv, s, d, reps, *rest in shapes:
        dv = rest[0] if rest else d
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        q, k, v, do = (torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
                       for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv),
                                     (b, hq, s, dv)))
        leaves_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = registry.variant_counts("flash_attention")["bf16_tc"]
        out = ops.attention(*leaves_in, causal=True)
        sync()
        check(DEVICE != "cuda"
              or registry.variant_counts("flash_attention")["bf16_tc"] == before + 1,
              "the forward of the gradient did not launch the tensor-core kernel")
        # (i) holds the kernel's kv tiling; on the CPU the plain forward ran
        ok, diffs = attention_checks(out.detach(), q, k, v)
        check(DEVICE != "cuda" or ok,
              f"flash_attention forward [{b},{hq},{s},{d}] of the gradient "
              f"differs: {diffs}")
        out.backward(do)
        del out
        got = [t.grad for t in leaves_in]
        del leaves_in
        f32 = [t.float().requires_grad_(True) for t in (q, k, v)]
        ref.attention_ref(*f32, causal=True).backward(do.float())
        want = [t.grad for t in f32]
        del f32
        errs = []
        for name, a, w in zip("qkv", got, want):
            floor = ATTN_BWD_FLOOR * float(w.abs().max())
            check(a.dtype == torch.bfloat16 and bf16_close(a, w, floor),
                  f"flash_attention backward d{name} [{b},{hq},{s},{d}] differs: "
                  f"{bf16_excess(a, w, floor):.3g} of its allowance")
            errs.append(float((a.float() - w).abs().max()))
        del got, want
        t = {"shape": [b, hq, hkv, s, d] + ([dv] if dv != d else []),
             "dtype": "bfloat16", "causal": True,
             "max_abs_err": max(errs), "forward_max_abs_err": diffs["bf16 (ii)"],
             "forward_allowance_used": [diffs["bf16 (i) ratio"],
                                        diffs["bf16 (ii) ratio"]],
             "ms": time_ms(lambda: ref.attention_backward(q, k, v, do), reps),
             "library_ms": sdpa_backward_ms(q, k, v, do, reps)}
        nbytes, fwd_ops = attention_cost(b, hq, hkv, s, d, 2, dv=dv)
        # do read and dq written besides the forward's traffic
        cost = (nbytes + b * hq * s * (d + dv) * 2, 2.5 * fwd_ops)
        t["bound_ms"], t["bound_by"] = bound(cost, PEAK_BF16_FLOPS_PER_S)
        log(f"flash_attention backward (plain, f32) [{b},{hq}/{hkv},{s},"
            f"{d if dv == d else f'{d}/{dv}'}] bf16 causal: {t['ms']:.4f} ms, "
            f"{t['library_ms']:.4f} ms SDPA backward, "
            f"{t['bound_ms']:.4f} ms bound ({t['bound_by']}: {cost[1] / 1e12:.3f} "
            f"TFLOP), {t['ms'] / t['bound_ms']:.2f}x bound; max |diff| vs f32 "
            f"autograd {max(errs):.3g}; the forward within its tolerance "
            f"({diffs['bf16 (i) ratio']:.3g}, {diffs['bf16 (ii) ratio']:.3g} of "
            f"its allowances)")
        rows.append(t)
        del q, k, v, do
    return rows


def gnn_stream(shape):
    """Phase 5d's background and stream (for a run of phase 11 alone)."""
    cfg, _, n_classes = gnn_setup()
    g = gen.erdos_renyi_graph(shape.n_nodes, shape.n_edges / shape.n_nodes, seed=SEED)
    feats, labels = gnn_features(g.n, shape.d_feat, n_classes, SEED)
    return SampledBatchStream(g, feats, labels, shape.fanout, shape.batch_nodes,
                              seed=SEED, device=DEVICE)


def phase_gnn_train_full(stream=None, shape=None):
    """11c: graphsage-reddit training on minibatch_lg over 5d's graph and
    stream: per step, host sampling, the gather, and forward + backward +
    AdamW; the loss, peak memory, segment_agg launches per step, and the
    device's busy share over two more steps."""
    cfg, full_shape, n_classes = gnn_setup()
    shape = shape or full_shape
    log(f"== phase 11c: {cfg.name} training on {shape.name} (B={shape.batch_nodes}, "
        f"fanouts {shape.fanout}, {GNN_TRAIN_STEPS} AdamW steps)")
    if stream is None:
        stream = gnn_stream(shape)
    model = GNN(cfg, shape.d_feat, n_classes, device=DEVICE, seed=SEED)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1,
                     total_steps=GNN_TRAIN_STEPS)
    state, step = init_train_state(model, tc), build_train_step(model, tc)
    step(state, stream(GNN_TRAIN_STEPS + 5))   # warm-up, outside the count
    sync()
    reset_peak()
    registry.reset_launches()
    rows = []
    for i in range(GNN_TRAIN_STEPS):
        ta = time.perf_counter()
        layers = stream.sample_ids(i)
        tb = time.perf_counter()
        batch = stream.gather(layers)
        sync()
        tc_ = time.perf_counter()
        state, met = step(state, batch)
        lv = float(met["loss"])
        td = time.perf_counter()
        check(np.isfinite(lv), f"step {i}: loss not finite")
        rows.append((tb - ta, tc_ - tb, td - tc_, lv))
        log(f"  step {i}: sample {tb - ta:.6f} s (host), gather {tc_ - tb:.6f} s, "
            f"forward+backward+update {td - tc_:.6f} s, loss {lv:.6f}")
    launches = registry.launch_counts()
    res = {"peak_gib": peak_gib(),
           "segment_agg_per_step": launches["segment_agg"] / GNN_TRAIN_STEPS,
           "median_s": [float(np.median([r[j] for r in rows])) for j in range(3)],
           "loss_first_last": [rows[0][3], rows[-1][3]]}
    res["step_s"] = float(np.median([sum(r[:3]) for r in rows]))
    check(DEVICE != "cuda" or launches["segment_agg"] == 3 * GNN_TRAIN_STEPS,
          f"segment_agg launched {launches['segment_agg']} times in "
          f"{GNN_TRAIN_STEPS} steps, expected 3 a step")
    log(f"median per step: {res['step_s']:.6f} s = sample {res['median_s'][0]:.6f} + "
        f"gather {res['median_s'][1]:.6f} + forward+backward+update "
        f"{res['median_s'][2]:.6f}; loss {rows[0][3]:.6f} -> {rows[-1][3]:.6f}; "
        f"max_memory_allocated {res['peak_gib']:.3f} GiB; segment_agg launches "
        f"{res['segment_agg_per_step']:.0f} per step (forward only; the backward "
        f"is plain)")

    def two_steps():
        s = state
        for i in range(2):
            s, _ = step(s, stream(GNN_TRAIN_STEPS + 10 + i))
    res["device_ms_per_step"] = profile_device(two_steps, 2, "train step", "segment_agg")
    return res


def phase_lm_train_full(cfg=None, seq=None, batch=LM_TRAIN_BATCH,
                        micro=LM_TRAIN_MICRO, steps=LM_TRAIN_STEPS):
    """11d: qwen2-1.5b training at full width: train_4k cut to `batch`
    sequences as `micro` microbatches, full remat, bf16 parameters and f32
    AdamW moments: seconds, tokens/s, peak memory, launches per step (those
    made inside the backward, remat's recomputed forwards, counted apart by
    the registry in the same run), and the busy share over one more step."""
    cfg = cfg or get_arch(LM_ARCH).CONFIG
    seq = seq or get_arch(LM_ARCH).SHAPES[LM_TRAIN_SHAPE].seq_len
    log(f"== phase 11d: {cfg.name} training at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.dtype} parameters, f32 AdamW moments): "
        f"{LM_TRAIN_SHAPE} with global_batch 256 cut to {batch} = {micro} "
        f"microbatches of {batch // micro} x {seq} tokens, remat=True, {steps} steps")
    model = Transformer(cfg, device=DEVICE, seed=SEED)
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-4), microbatches=micro, remat=True,
                     warmup_steps=1, total_steps=steps)
    stream = SyntheticTokenStream(cfg.vocab, batch, seq, seed=SEED, device=DEVICE)
    state, step = init_train_state(model, tc), build_train_step(model, tc)
    reset_peak()
    registry.reset_launches()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, met = step(state, stream(i))
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
        log(f"  step {i}: {times[-1]:.3f} s, loss {losses[-1]:.6f}, grad_norm "
            f"{float(met['grad_norm']):.4f}")
    launches = registry.launch_counts()["flash_attention"]
    recomputed = registry.backward_launch_counts()["flash_attention"]
    res = {"step_s": float(np.median(times)), "peak_gib": peak_gib(),
           "losses": losses, "launches_per_step": launches / steps,
           "recomputed_per_step": recomputed / steps,
           "variants": registry.variant_counts("flash_attention")}
    res["tokens_per_s"] = batch * seq / res["step_s"]
    check(all(np.isfinite(losses)), f"losses not finite: {losses}")
    want = micro * cfg.n_layers
    check(DEVICE != "cuda" or (launches == steps * 2 * want
                               and recomputed == steps * want),
          f"flash_attention launched {launches} times in {steps} steps, "
          f"{recomputed} of them in the backward; expected {2 * want} a step, "
          f"{want} of them in the backward")
    check(DEVICE != "cuda" or cfg.dtype != "bfloat16"
          or res["variants"]["bf16_tc"] == launches,
          f"launches by variant {res['variants']}: all must be the tensor-core kernel")
    log(f"median step {res['step_s']:.3f} s, {res['tokens_per_s']:.0f} tokens/s, "
        f"max_memory_allocated {res['peak_gib']:.3f} GiB; flash_attention "
        f"{res['launches_per_step']:.0f} launches a step, "
        f"{res['recomputed_per_step']:.0f} of them inside the backward (remat's "
        f"recomputed forwards; {micro} microbatches x {cfg.n_layers} layers), "
        f"by variant {res['variants']}")
    batch0 = stream(steps + 2)
    res["device_ms_per_step"] = profile_device(lambda: step(state, batch0), 1,
                                               "train step", "flash_attention")
    return res


def phase_recsys_train_full(cfg=None, users=RECSYS_TRAIN_USERS,
                            steps=RECSYS_TRAIN_STEPS):
    """11e: bert4rec training at full width with the full-catalog softmax."""
    cfg = cfg or get_arch(RECSYS_ARCH).CONFIG
    log(f"== phase 11e: {cfg.name} training at full width ({cfg.n_items + 2} x "
        f"{cfg.embed_dim} {cfg.dtype} table; train_batch 65,536 cut to {users} "
        f"users x {cfg.seq_len} positions; full-catalog softmax; {steps} steps)")
    model = Bert4Rec(cfg, device=DEVICE, seed=SEED)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1, total_steps=steps)
    stream = MaskedSequenceStream(cfg.n_items, users, cfg.seq_len, seed=SEED,
                                  device=DEVICE)
    state, step = init_train_state(model, tc), build_train_step(model, tc)
    step(state, stream(steps + 1))     # warm-up, outside the count
    sync()
    reset_peak()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, met = step(state, stream(i))
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
    res = {"step_s": float(np.median(times)), "peak_gib": peak_gib(), "losses": losses}
    check(all(np.isfinite(losses)), f"losses not finite: {losses}")
    log(f"steps {[round(t, 4) for t in times]} s (median {res['step_s']:.4f} s), "
        f"losses {[round(x, 6) for x in losses]}, max_memory_allocated "
        f"{res['peak_gib']:.3f} GiB")
    return res


def phase_trainer_restart_worker():
    """11f's body, in a process of its own (deterministic algorithms, with
    cuBLAS's workspace set before the first product): the trainer with a
    SimulatedFailure at RESTART_FAIL_AT and a checkpoint every
    RESTART_INTERVAL steps under a temporary directory, against the same run
    uninterrupted; prints the losses and "OK"."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serve_cli.serve_config(LM_ARCH)
    model = Transformer(cfg, device=DEVICE, seed=SEED)
    tc = train_tc()
    stream = SyntheticTokenStream(cfg.vocab, 4, 64, seed=SEED, device=DEVICE)
    step = build_train_step(model, tc)
    registry.reset_launches()
    clean = trainer.run(init_train_state(model, tc), step, stream, num_steps=RESTART_STEPS)
    fired = []

    def fail(s):
        if s == RESTART_FAIL_AT and not fired:
            fired.append(s)
            raise trainer.SimulatedFailure("injected")

    with tempfile.TemporaryDirectory() as d:
        rep = trainer.run(init_train_state(model, tc), step, stream, num_steps=RESTART_STEPS,
                          ckpt_dir=d, ckpt_interval=RESTART_INTERVAL, fail_hook=fail)
    # steps 0 .. FAIL_AT-1, then the retry from the last checkpoint
    back = RESTART_FAIL_AT - RESTART_FAIL_AT % RESTART_INTERVAL
    replay = rep.losses[:RESTART_FAIL_AT] + rep.losses[RESTART_FAIL_AT + RESTART_FAIL_AT - back:]
    print(json.dumps({"clean": clean.losses, "restarted": rep.losses,
                      "restarts": rep.restarts,
                      "launches": registry.launch_counts()["flash_attention"]}))
    check(rep.restarts == 1 and rep.final_step == RESTART_STEPS,
          f"restarts {rep.restarts}, final step {rep.final_step}")
    check(rep.losses[back:RESTART_FAIL_AT] == rep.losses[RESTART_FAIL_AT:2 * RESTART_FAIL_AT - back]
          and replay == clean.losses,
          f"restarted losses {rep.losses} differ from {clean.losses}")
    check(DEVICE != "cuda" or registry.launch_counts()["flash_attention"] > 0,
          "the trainer's steps did not launch flash_attention")
    print("OK")


def phase_trainer_restart():
    """11f: the trainer restart on the card, in its own process."""
    log(f"== phase 11f: trainer restart ({RESTART_STEPS} steps, SimulatedFailure at "
        f"step {RESTART_FAIL_AT}, checkpoints every {RESTART_INTERVAL}) under "
        "torch.use_deterministic_algorithms(True)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    code = (f"import chip_smoke as cs; cs.DEVICE = {DEVICE!r}; "
            "cs.phase_trainer_restart_worker()")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=ROOT)
    log(proc.stdout.strip())
    check(proc.returncode == 0 and proc.stdout.strip().endswith("OK"),
          f"the trainer restart failed ({proc.returncode}): {proc.stderr[-3000:]}")
    log(f"restarted losses equal the uninterrupted run's ({time.perf_counter() - t0:.1f} s)")


def gnn_train_fields(gnn):
    """11c's fields of the segment_agg entry of the JSON line."""
    return {"launches_train_step": gnn["segment_agg_per_step"], "train_gnn": gnn}


def run_train(with_gnn=True):
    """The training path (phase 11) -> extra fields of the segment_agg and
    flash_attention entries of the JSON line: their launches a train step
    and their plain backwards' times. `main` runs 11c inside `run_gnn`, on
    5d's stream, and passes with_gnn=False; alone, phase 11 builds that
    stream for 11c."""
    t0 = time.perf_counter()
    cfg, shape, _ = gnn_setup()
    phase_train_parity()
    agg_bwd = phase_segment_agg_backward(agg_shapes(shape, cfg))
    attn_bwd = phase_attention_backward(ATTN_BWD_SHAPES)
    gnn = gnn_train_fields(phase_gnn_train_full()) if with_gnn else {}
    lm = phase_lm_train_full()
    rec = phase_recsys_train_full()
    phase_trainer_restart()
    log(f"phase 11{'' if with_gnn else ' (11c ran in the GNN path)'}: "
        f"{time.perf_counter() - t0:.1f} s ({CARD})")
    return {
        "segment_agg": {"backward_plain": agg_bwd, **gnn},
        "flash_attention": {"launches_train_step": lm["launches_per_step"],
                            "launches_train_recomputed": lm["recomputed_per_step"],
                            "backward_plain": attn_bwd, "train_lm": lm},
        "embedding_bag": {"train_recsys": rec},
    }


def sharded_graph():
    """(the R-MAT graph of phases 9b-10c at SCALE_SHARDED, its local prune
    of hex-unique on the card: omega, edge mask, trajectory, count and
    seconds, which those phases hold their prunes to)."""
    g, s_gen = timed(lambda: gen.rmat_graph(SCALE_SHARDED, edge_factor=EDGE_FACTOR,
                                            seed=SEED))
    tmpl = Template(*HEX)
    local, s_prune = timed(lambda: prune(g, tmpl, device=DEVICE))
    cnt = count_matches(local)
    log(f"R-MAT scale {SCALE_SHARDED} for phases 9b-10c: n={g.n} m={g.m} "
        f"(generated in {s_gen:.1f} s); the local prune {s_prune:.3f} s, "
        f"{local.counts()}, {cnt.n_embeddings} matches")
    ref = {"omega": local.omega, "edge_mask": local.edge_mask,
           "traj": trajectory(local), "count": cnt.n_embeddings,
           "seconds": sum(p.seconds for p in local.phases)}
    return g, ref


def run_prune():
    """The prune path (phases 2-4), many queries against one graph (phase
    8) and a sharded graph (phases 9, 10) -> their kernels' entries of the
    JSON line, with their launches on the main path (phase 4), on the
    edge-prune, tuned and planned prunes (4b, 4c), serving the 32-query
    workload (8b), on the incremental path (8c), and, for bitset_spmm, on
    the P = 2 sharded prune and count (9b, `launches_sharded`) and the spmd
    prune (9c). Phase 10a's CPU side runs in a process of its own from the
    start, beside the card's phases."""
    # no dispatch policy: a cache left in the checkout must not move the
    # routes of phases 2-4 off the kernels (4c installs its own and clears it)
    registry.set_policy(None)
    phase_kernels_small()
    worker = start_phase10_worker()
    try:
        return prune_path(worker)
    finally:
        stop_worker(worker)


def prune_path(worker):
    """`run_prune`'s phases 2-10, beside 10a's CPU worker."""
    t0 = time.perf_counter()
    g = gen.rmat_graph(SCALE_FULL, edge_factor=EDGE_FACTOR, seed=SEED)
    t1 = time.perf_counter()
    dg = DeviceGraph.from_host(g, DEVICE)
    sync()
    log(f"R-MAT scale {SCALE_FULL}: n={g.n} m={g.m}, max in-degree "
        f"{int((dg.dst_ptr[1:] - dg.dst_ptr[:-1]).max())} (generated on the "
        f"host in {t1 - t0:.1f} s, dst-sorted and staged in "
        f"{time.perf_counter() - t1:.1f} s)")
    timing = phase_kernel_timing(dg, Template(*HEX), g.label_frequency())
    g14 = phase_parity()
    phase_parity_a2(g14)
    phase_join_many(g14)
    launches, default, cnt = phase_full(g, dg)
    edge = phase_edge_prune_full(g, dg, default, cnt.n_embeddings)
    plans = phase_planner_policy(g, dg, default, cnt.n_embeddings)
    phase_quickstart_cli()
    del default
    # phase 8: many queries against one graph, the same two kernels
    t0 = time.perf_counter()
    phase_batch_parity(g14)
    served = phase_batch_full(g, dg)
    inc = phase_incremental_full(g, dg)
    del dg, g
    phase_batch_clis()
    log(f"phase 8: {time.perf_counter() - t0:.1f} s ({CARD})")
    # phase 9: a sharded graph, bitset_spmm as each shard's receive side
    t0 = time.perf_counter()
    phase_sharded_parity(g14, worker)
    g, ref = sharded_graph()
    sharded, parts = phase_sharded_full(g, ref)
    spmd, part1 = phase_spmd_nccl(g, ref)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s ({CARD})")
    # phase 10: checkpoint and rebalance, sharded batches, faults
    t0 = time.perf_counter()
    rebalanced = phase_checkpoint_rebalance(
        g, ref, parts, part1, sharded[1]["prune_s"])
    sharded_batch = phase_sharded_batches(g, parts)
    del g, parts, part1
    phase_resilience_parity(g14, worker)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s ({CARD})")
    return [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitset.cu",
        "replaces": replaces, "launches": launches[name], "library_ms": None,
        "bit_exact": True, **timing[name],
        "launches_edge_prune": edge["launches"][name],
        "launches_tuned": plans["tuned"]["launches"][name],
        "launches_planned": plans["planned"]["launches"][name],
        "launches_batched_serving": served["launches"][name],
        "batches_served": served["batches"],
        "launches_incremental": inc["launches"][name],
        "launches_rebalanced_lb1": rebalanced[2]["launches"][name],
        **({"launches_sharded": sharded[0]["launches"],
            "launches_spmd": spmd["launches"],
            "launches_resilient_restart": rebalanced[0]["launches"][name],
            "launches_sharded_batch": sharded_batch["launches"][name],
            "sharded_batch_wave": sharded_batch["wave"],
            "sharded_receive": [
                {k: r[k] for k in ("P", "wave", "slots", "launches",
                                   "receive_ms", "receive_plain_ms",
                                   "receive_bound_ms", "receive_max_abs_err",
                                   "hop_receive_ms", "hop_receive_bound_ms",
                                   "hop_receive_max_abs_err")}
                for r in sharded]}
           if name == "bitset_spmm" else {}),
    } for name, replaces in (("bitset_spmm", "src/repro/kernels/bitset_spmm.py:77"),
                             ("bitset_wave", "src/repro/kernels/bitset_wave.py:89"))]


def run_gnn():
    """The GNN path (phase 5), and its training on 5d's stream (11c) -> its
    kernel's entry of the JSON line."""
    cfg, shape, _ = gnn_setup()
    phase_segment_agg_small()
    agg_rows = phase_segment_agg_timing(agg_shapes(shape, cfg))
    phase_gnn_parity()
    launches, stream = phase_gnn_full()
    # 11c trains on 5d's graph and stream while they are on the card; they
    # go when this returns, before phases 6 and 7 read their peak memory
    train = gnn_train_fields(phase_gnn_train_full(stream))
    del stream
    t = agg_rows[0]  # the largest call: second-hop neighbours
    return [{
        "name": "segment_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_agg.cu",
        "replaces": "src/repro/kernels/segment_agg.py:47",
        "launches": launches["segment_agg"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
        "tolerance": f"min/max bit-exact, sum/sumsq rtol=atol={AGG_TOL}",
        "device_ms": t["device_ms"],
        "other_shapes": [{k: r[k] for k in ("shape", "ms", "device_ms",
                                            "plain_ms", "bound_ms")}
                         for r in agg_rows[1:]],
        **train,
    }]


def run_lm():
    """The LM path (phase 6) -> its kernel's entry of the JSON line."""
    phase_attention_small()
    attn_rows = phase_attention_timing(ATTN_TIMING_SHAPES)
    phase_lm_parity()
    launches, lm = phase_lm_full()
    phase_serve_cli("6e", LM_ARCH)
    t = attn_rows[0]  # the prefill_32k sequence
    return [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "f32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": launches["flash_attention"],
        "launches_prefill_32k": lm["prefill_32k_launches"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": t["shape"],
        "tolerance": ATTN_TOLERANCE,
        "variant": t["variant"], "max_abs_err_tile": t["max_abs_err_tile"],
        "allowance_used": t["allowance_used"],
        "launches_by_variant": lm["serve_variants"],
        "other_shapes": [{k: r[k] for k in ("shape", "ms", "device_ms",
                                            "plain_ms", "library_ms",
                                            "bound_ms", "max_abs_err",
                                            "max_abs_err_tile", "allowance_used")}
                         for r in attn_rows[1:]],
        "lm": lm,
    }]


def run_recsys():
    """The recsys path (phase 7) -> its kernel's entry of the JSON line."""
    cfg = get_arch(RECSYS_ARCH).CONFIG
    phase_embedding_bag_small()
    t = phase_embedding_bag_timing(
        cfg.n_items + 2, cfg.embed_dim,
        get_arch(RECSYS_ARCH).SHAPES["retrieval_cand"].n_candidates)
    phase_recsys_parity()
    launches, rec = phase_recsys_full()
    phase_serve_cli("7e", RECSYS_ARCH)
    return [{
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:45",
        "launches": launches["embedding_bag"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": t["shape"],
        "tolerance": f"f32 rtol=atol={BAG_TOL}; bf16 2 ulps + 1e-6; "
                     "bit-exact at the retrieval shape",
        "recsys": rec,
    }]


# ---------------------------------------------------- phase 12: the LM archs
# Phase 12: the four other LM archs of the JAX package. 12a holds
# flash_attention at MLA's (Dqk, Dv) = (192, 128) (DeepSeek's qk_nope +
# qk_rope, and v_head_dim; the heads are the kv heads) and times it at one
# deepseek-v2-lite prefill_32k sequence. 12b: card against CPU at full width
# cut to 2 layers in f32 (deepseek: 1 dense + 1 MoE layer; deepseek-v3's
# routed experts cut from 256 to 16 so that its CPU copy fits the host's
# memory, top-8 kept; starcoder2's window cut to 64, so that a 56-token
# prompt and 24 new tokens wrap its ring). 12c: full width in bf16, random
# weights, one arch at a time, each freed before the next: the prefill_32k
# program on one sequence (global batch 32 cut to 1), then greedy serving
# (decode_32k's batch of 128 cut to LM_ARCH_SERVE's); deepseek-v3 cut to 4
# layers (its 3 dense + 1 MoE layer of 256 experts) and the MTP block.
LM_ARCHS = ("qwen3-8b", "starcoder2-15b", "deepseek-v2-lite-16b", "deepseek-v3-671b")
MLA_PAIR = (192, 128)
MLA_SMALL_HEADS, MLA_SMALL_LENGTHS = (16, 128), (1, 77, 1000, 4096)
# (B, H, S, reps): one deepseek-v2-lite prefill_32k sequence, 16 heads
MLA_TIMING_SHAPE = (1, 16, 32768, 3)
LM_ARCH_PARITY_LAYERS, LM_ARCH_PARITY_BATCH = 2, 2
LM_ARCH_PARITY_V3_ROUTED = 16
LM_ARCH_PARITY_WINDOW = 64
# (prompt, new tokens) card vs CPU; starcoder2 crosses its cut window of 64
LM_ARCH_PARITY_LEN = {"starcoder2-15b": (56, 24)}
LM_ARCH_PARITY_DEFAULT_LEN = (64, 8)
# (requests, prompt, new tokens) of 12c's serving
LM_ARCH_SERVE = {"qwen3-8b": (8, 2048, 32), "starcoder2-15b": (4, 4064, 64),
                 "deepseek-v2-lite-16b": (8, 2048, 32), "deepseek-v3-671b": (4, 1024, 16)}
LM_ARCH_V3_LAYERS = 4
LM_ARCH_V3_LOSS_TOKENS = 4096
# decode steps past starcoder2's window of 4096 held to the windowed forward
RING_PAST_WINDOW = 4


def plain_calls_on_card():
    """The plain-version calls on CUDA tensors since the last reset (none
    may run on the card's main path)."""
    return {k: v for k, v in registry.plain_counts().items() if v}


def mla_qkv(shape, dtype, gen, kv_view=False):
    """q, k [B, H, S, 192] and v [B, H, S, 128] drawn from `gen`; kv_view:
    v as the model passes it, a view of the [B, S, H, 128 + 128] kv
    projection."""
    b, h, s = shape
    dqk, dv = MLA_PAIR
    q = (torch.randn((b, h, s, dqk), generator=gen, device=DEVICE) * 0.3).to(dtype)
    k = (torch.randn((b, h, s, dqk), generator=gen, device=DEVICE) * 0.3).to(dtype)
    if kv_view:
        kv = (torch.randn((b, s, h, 128 + dv), generator=gen, device=DEVICE) * 0.3).to(dtype)
        return q, k, kv.transpose(1, 2)[..., 128:]
    return q, k, (torch.randn((b, h, s, dv), generator=gen, device=DEVICE) * 0.3).to(dtype)


def phase_attention_mla():
    """12a: flash_attention at MLA's (192, 128) against its plain version,
    both variants, causal, S in MLA_SMALL_LENGTHS x H in MLA_SMALL_HEADS and
    v as a view of the kv projection; ptxas's registers and spills of the
    new instantiations; times at one deepseek-v2-lite prefill_32k sequence
    beside the bound, the plain version and SDPA (Ev != E)."""
    log(f"== phase 12a: flash_attention at MLA's (Dqk, Dv) = {MLA_PAIR} ({CARD})")
    for fn, line in ptxas_report("flash_attention") if DEVICE == "cuda" else ():
        if "Li192ELi128E" in fn:   # the new instantiations
            log(f"  ptxas {fn}: {line}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst = dict.fromkeys(("f32", "bf16 (i)", "bf16 (i) ratio", "bf16 (ii)",
                           "bf16 (ii) ratio"), 0.0)
    cases = [((1, h, s), False) for h in MLA_SMALL_HEADS for s in MLA_SMALL_LENGTHS]
    cases.append(((2, 16, 300), True))
    for shape, kv_view in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = mla_qkv(shape, dtype, gen, kv_view)
            got = attention_variant_launches(lambda: ops.attention(q, k, v),
                                             ops.attention_variant(dtype, *MLA_PAIR))
            sync()
            ok, diffs = attention_checks(got, q, k, v)
            check(got.shape == (*shape, MLA_PAIR[1]) and got.dtype == dtype and ok,
                  f"flash_attention MLA {list(shape)} {dtype} view={kv_view} "
                  f"differs: {diffs}")
            for key, val in diffs.items():
                worst[key] = max(worst[key], val)
            del q, k, v, got
    log(f"{2 * len(cases)} MLA kernel/plain comparisons within tolerance: max |diff| "
        f"f32 {worst['f32']:.3g}, bf16 (i) {worst['bf16 (i)']:.3g} "
        f"({worst['bf16 (i) ratio']:.3g} of its allowance), (ii) "
        f"{worst['bf16 (ii)']:.3g} ({worst['bf16 (ii) ratio']:.3g})")

    b, h, s, reps = MLA_TIMING_SHAPE
    q, k, v = mla_qkv((b, h, s), torch.bfloat16, gen)
    got = attention_variant_launches(lambda: ops.attention(q, k, v), "bf16_tc")
    ok, diffs = attention_checks(got, q, k, v)
    check(ok, f"flash_attention MLA [{b},{h},{s},{MLA_PAIR}] differs: {diffs}")
    del got
    t = {"shape": [b, h, h, s, *MLA_PAIR], "dtype": "bfloat16", "variant": "bf16_tc",
         "max_abs_err": diffs["bf16 (ii)"], "max_abs_err_tile": diffs["bf16 (i)"],
         "allowance_used": [diffs["bf16 (i) ratio"], diffs["bf16 (ii) ratio"]]}
    t["ms"] = time_ms(lambda: ops.attention(q, k, v), reps)
    t["device_ms"] = kernel_device_ms(lambda: ops.attention(q, k, v), reps,
                                      "flash_attention")
    t["plain_ms"] = time_ms(lambda: ref.attention_plain(q, k, v), 1)
    t["library_ms"] = sdpa_ms(q, k, v, reps)
    cost = attention_cost(b, h, h, s, MLA_PAIR[0], 2, dv=MLA_PAIR[1])
    t["bound_ms"], t["bound_by"] = bound(cost, PEAK_BF16_FLOPS_PER_S)
    lib = t["library_ms"]
    log(f"flash_attention [{b},{h}/{h},{s},{MLA_PAIR[0]}/{MLA_PAIR[1]}] bf16 causal "
        f"({CARD}): {t['ms']:.4f} ms kernel ({t['device_ms']:.4f} ms on the device, "
        f"{cost[1] / t['device_ms'] / 1e9:.1f} TFLOP/s, "
        f"{t['device_ms'] / t['bound_ms']:.2f}x bound), {t['plain_ms']:.4f} ms plain, "
        f"{'not taken' if lib is None else f'{lib:.4f} ms'} SDPA, "
        f"{t['bound_ms']:.4f} ms bound ({t['bound_by']}: {cost[1] / 1e12:.3f} TFLOP, "
        f"{cost[0] / 1e6:.1f} MB); max |diff| (i) {diffs['bf16 (i)']:.3g} "
        f"({diffs['bf16 (i) ratio']:.3g} of its allowance), (ii) "
        f"{diffs['bf16 (ii)']:.3g} ({diffs['bf16 (ii) ratio']:.3g})")
    del q, k, v
    return t


def lm_parity_config(arch):
    """12b's config: `arch` at full width, cut to LM_ARCH_PARITY_LAYERS
    layers in f32 (deepseek: 1 dense + 1 MoE layer; v3's routed experts to
    LM_ARCH_PARITY_V3_ROUTED; starcoder2's window to LM_ARCH_PARITY_WINDOW)."""
    cfg = get_arch(arch).CONFIG
    kw = {"n_layers": LM_ARCH_PARITY_LAYERS, "dtype": "float32"}
    if cfg.moe:
        kw["first_dense_layers"] = 1
    if arch == "deepseek-v3-671b":
        kw["n_routed"] = LM_ARCH_PARITY_V3_ROUTED
    if cfg.window:
        kw["window"] = LM_ARCH_PARITY_WINDOW
    return dataclasses.replace(cfg, **kw)


def phase_lm_arch_parity(arch, cfg=None, sizes=None):
    """12b: card against CPU, the same weights on both (made on the card,
    copied to the host): prefill logits and greedy tokens, as 6c."""
    cfg = cfg or lm_parity_config(arch)
    batch = LM_ARCH_PARITY_BATCH
    prompt_len, new = sizes or LM_ARCH_PARITY_LEN.get(arch, LM_ARCH_PARITY_DEFAULT_LEN)
    log(f"== phase 12b: {cfg.name} card vs CPU ({cfg.n_layers} layers"
        f"{f', {cfg.first_dense_layers} dense + {cfg.n_layers - cfg.first_dense_layers} MoE, {cfg.n_routed} routed experts top-{cfg.top_k}' if cfg.moe else ''}"
        f"{', window ' + str(cfg.window) if cfg.window else ''}, f32, B={batch}, "
        f"S={prompt_len}, {new} greedy tokens; {CARD})")
    t0 = time.perf_counter()
    cpu = Transformer(cfg, device=DEVICE, seed=SEED).to("cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    log(f"weights made on the card and copied to the host in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = SyntheticTokenStream(cfg.vocab, batch, prompt_len, seed=SEED,
                                  device="cpu")(0)["tokens"]
    out = {}
    registry.reset_launches()
    for dev, model in ((DEVICE, card), ("cpu", cpu)):
        t0 = time.perf_counter()
        _, logits = build_prefill(model)(prompt.to(dev), prompt_len + new)
        toks = greedy_generate(model, prompt.to(dev), new, prompt_len + new)
        sync()
        out[dev] = (logits.cpu(), toks.cpu(), time.perf_counter() - t0)
    (lc, tc, sc), (lp, tp, sp) = out[DEVICE], out["cpu"]
    if DEVICE == "cuda":
        variants = registry.variant_counts("flash_attention")
        check(variants["f32"] == 2 * cfg.n_layers and sum(variants.values()) == variants["f32"],
              f"the card's prefills launched flash_attention {variants}, expected "
              f"{2 * cfg.n_layers} of the f32 kernel")
        check(not plain_calls_on_card(), f"plain calls on the card: {plain_calls_on_card()}")
    diff = float((lc - lp).abs().max())
    check(torch.allclose(lc, lp, rtol=LM_PARITY_TOL, atol=LM_PARITY_TOL),
          f"{arch}: prefill logits differ card vs CPU by {diff:.3g}")
    check(torch.equal(tc, tp), f"{arch}: greedy tokens differ: {tc.tolist()} vs {tp.tolist()}")
    log(f"last logits [{batch}, {cfg.vocab}] max |card - CPU| {diff:.3g} "
        f"(tolerance {LM_PARITY_TOL}); {new} greedy tokens equal: {tc[0].tolist()}; "
        f"card {sc:.2f} s, CPU {sp:.2f} s")
    del cpu, card
    return {"max_abs_err": diff, "tokens": new}


def phase_ring_past_window(n_past=RING_PAST_WINDOW, cfg=None):
    """12c, starcoder2: at full width in f32 cut to 2 layers, on the card,
    each of n_past decode steps past the window (4096) against the logits
    of the same prefix from one forward through the kernel's window: the
    ring (its first wrap at position 4096) against the kernel."""
    cfg = cfg or dataclasses.replace(get_arch("starcoder2-15b").CONFIG, n_layers=2,
                                     dtype="float32")
    w = cfg.window
    log(f"== phase 12c: {cfg.name}'s ring cache past its window of {w} (2 layers, "
        f"f32, on the card): {n_past} decode steps against the windowed forward "
        f"({CARD})")
    model = Transformer(cfg, device=DEVICE, seed=SEED)
    toks = SyntheticTokenStream(cfg.vocab, 1, w + n_past, seed=SEED + 2,
                                device=DEVICE)(0)["tokens"]
    h, _ = model.forward_hidden(toks)
    want = model.logits_from_hidden(h[:, w:]).cpu()
    del h
    cache, _ = build_prefill(model)(toks[:, :w], w + n_past)
    check(cache["layers"]["k"].shape[3] == w, "the ring is not the window's size")
    worst = 0.0
    for i in range(n_past):
        logits, cache = model.decode_step(toks[:, w + i], cache)
        diff = float((logits.cpu() - want[:, i]).abs().max())
        worst = max(worst, diff)
        check(torch.allclose(logits.cpu(), want[:, i], rtol=LM_PARITY_TOL,
                             atol=LM_PARITY_TOL),
              f"decode at position {w + i} differs from the windowed forward by {diff:.3g}")
    log(f"decode at positions {w}..{w + n_past - 1} (the ring wraps at {w}) equals "
        f"the kernel's windowed forward: max |diff| {worst:.3g} (tolerance {LM_PARITY_TOL})")
    del model, cache
    return worst


def lm_full_config(arch):
    cfg = get_arch(arch).CONFIG
    if arch == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, n_layers=LM_ARCH_V3_LAYERS)
    return cfg


def free_card():
    import gc

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def phase_lm_arch_full(arch, cfg=None, prefill_len=None, serve=None):
    """12c: `arch` at full width in bf16 (deepseek-v3 cut in depth): the
    prefill_32k program on one sequence, greedy serving, and for
    deepseek-v3 its loss (MTP and the aux loss) once without gradients;
    launch counts, variants and plain calls read around each."""
    cfg = cfg or lm_full_config(arch)
    prefill_len = prefill_len or get_arch(arch).SHAPES[LM_PREFILL_SHAPE].seq_len
    b, p, new = serve or LM_ARCH_SERVE[arch]
    n = cfg.n_layers
    log(f"== phase 12c: {cfg.name} at full width ({n} layers"
        f"{f' ({cfg.first_dense_layers} dense + {n - cfg.first_dense_layers} MoE of {cfg.n_routed} experts top-{cfg.top_k}, {cfg.n_shared} shared)' if cfg.moe else ''}"
        f"{', MTP' if cfg.mtp else ''}, d_model {cfg.d_model}, {cfg.attention}, "
        f"{cfg.dtype}; {CARD})")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=DEVICE, seed=SEED)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in model.params.values())
    res = {"n_layers": n, "weights_gb": n_bytes / 1e9,
           "init_s": time.perf_counter() - t0}
    log(f"random weights made on the device in {res['init_s']:.2f} s: "
        f"{cfg.n_params()} parameters by n_params, {n_bytes / 1e9:.3f} GB in all")

    def launches_ok(what, want):
        variants = registry.variant_counts("flash_attention")
        got = registry.launch_counts()["flash_attention"]
        plain = plain_calls_on_card()
        if DEVICE == "cuda":
            check(got == want and variants["bf16_tc"] == want,
                  f"{what}: flash_attention {got} launches ({variants}), expected "
                  f"{want}, all bf16_tc")
            check(not plain, f"{what}: plain calls on the card: {plain}")
        return {"launches": got, "variants": variants, "plain_calls": plain}

    # (i) prefill_32k: forward_hidden + last-position logits, one sequence
    toks = SyntheticTokenStream(cfg.vocab, 1, prefill_len, seed=SEED,
                                device=DEVICE)(0)["tokens"]
    model.forward_hidden(toks[:, :256])   # warm-up, outside the count
    sync()
    reset_peak()
    registry.reset_launches()
    t0 = time.perf_counter()
    h, aux = model.forward_hidden(toks)
    logits = model.logits_from_hidden(h[:, -1:])[:, 0]
    sync()
    res["prefill_32k_s"] = time.perf_counter() - t0
    res["prefill_32k_peak_gib"] = peak_gib()
    res["prefill_32k"] = launches_ok("prefill_32k", n)
    check(logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(aux)), "prefill_32k logits not finite or misshapen")
    log(f"(i) prefill_32k, 1 x {prefill_len} tokens: {res['prefill_32k_s']:.3f} s, "
        f"{prefill_len / res['prefill_32k_s']:.0f} tokens/s, flash_attention "
        f"{res['prefill_32k']['launches']} launches ({res['prefill_32k']['variants']}), "
        f"plain calls {res['prefill_32k']['plain_calls']}, router aux {float(aux):.4f}, "
        f"max_memory_allocated {res['prefill_32k_peak_gib']:.3f} GiB")
    del h, logits, aux
    # device time by kernel and the busy share over one more prefill_32k
    res["prefill_32k_device_ms"] = profile_device(
        lambda: model.forward_hidden(toks), 1, "prefill_32k", "flash_attention")
    del toks

    # (ii) greedy serving, the prefill and each decode step timed apart
    prompts = SyntheticTokenStream(cfg.vocab, b, p, seed=SEED + 1,
                                   device=DEVICE)(0)["tokens"]
    greedy_generate(model, prompts[:, :64], 2, 66)   # warm-up, outside the count
    sync()
    reset_peak()
    registry.reset_launches()
    step = build_decode_step(model)
    t0 = time.perf_counter()
    cache, logits = build_prefill(model)(prompts, p + new)
    sync()
    res["serve_prefill_s"] = time.perf_counter() - t0
    tok = logits.argmax(-1).to(torch.int32)
    toks, step_s = [tok], []
    for _ in range(new - 1):
        t1 = time.perf_counter()
        tok, _, cache = step(cache, tok)
        sync()
        step_s.append(time.perf_counter() - t1)
        toks.append(tok)
    res["serve_s"] = time.perf_counter() - t0
    out = torch.stack(toks, 1)
    res["serve_peak_gib"] = peak_gib()
    res["serve"] = launches_ok("serving", n)
    check(out.shape == (b, new) and bool(((out >= 0) & (out < cfg.vocab)).all()),
          "generated tokens of the wrong shape or out of the vocabulary")
    res["decode_ms_median"] = float(np.median(step_s)) * 1e3
    res["serve_tokens_per_s"] = b * new / res["serve_s"]
    if cfg.window:
        res["ring_slots"] = int(cache["layers"]["k"].shape[3])
    log(f"(ii) serving {b} requests x {p}-token prompts, {new} new tokens"
        f"{f' (positions to {p + new - 1}: the ring of {cfg.window} wraps)' if cfg.window and p + new > cfg.window else ''}: "
        f"{res['serve_s']:.3f} s end to end, {res['serve_tokens_per_s']:.1f} generated "
        f"tokens/s; prefill {res['serve_prefill_s']:.3f} s, decode "
        f"{res['decode_ms_median']:.3f} ms per token (median of {len(step_s)}); "
        f"flash_attention {res['serve']['launches']} launches, plain calls "
        f"{res['serve']['plain_calls']}; max_memory_allocated "
        f"{res['serve_peak_gib']:.3f} GiB; first tokens {out[0, :8].tolist()}")
    del cache, logits, prompts

    # (iii) deepseek-v3: the loss with MTP and the aux loss, no gradients
    if cfg.mtp:
        batch = SyntheticTokenStream(cfg.vocab, 1, LM_ARCH_V3_LOSS_TOKENS, seed=SEED + 3,
                                     device=DEVICE)(0)
        reset_peak()
        registry.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, met = model.loss(batch)
        sync()
        res["loss_s"] = time.perf_counter() - t0
        res["loss"] = {"loss": float(loss), "ce": float(met["ce"]), "aux": float(met["aux"])}
        res["loss_launches"] = launches_ok("loss", n + 1)
        res["loss_peak_gib"] = peak_gib()
        check(all(np.isfinite(list(res["loss"].values()))), f"loss not finite: {res['loss']}")
        log(f"(iii) loss on 1 x {LM_ARCH_V3_LOSS_TOKENS} tokens without gradients "
            f"(CE + 0.3 MTP CE + {cfg.router_aux_coef} aux): {res['loss']}, "
            f"{res['loss_s']:.3f} s, flash_attention {res['loss_launches']['launches']} "
            f"launches ({n} layers + the MTP block), max_memory_allocated "
            f"{res['loss_peak_gib']:.3f} GiB")
    del model
    free_card()
    return res


# 12d: each arch's served smoke config (`serve_config`: head dims raised to
# a pair the kernel takes), card vs CPU in f32: TRAIN_STEPS steps of the
# train step with LM_ARCH_TRAIN_MICRO microbatches and full remat, through
# 11a's train_card_vs_cpu and its tolerances; deepseek-v3 keeps its cell's
# bf16 moments (`launch/cells.py` LM_STATE_DTYPE)
LM_ARCH_TRAIN_MICRO = 2
LM_ARCH_TRAIN_TOKENS = (4, 64)
# a token whose k-th and (k+1)-th router probabilities lie closer than this
# is a routing tie (hazard (ii)): printed, no seed picked to avoid one
ROUTING_NEAR_TIE = 1e-6
# 12e: full width in bf16 at a cut depth: train_4k (global_batch 256) cut
# to LM_TRAIN_BATCH = 2 sequences of 4,096 tokens as 2 microbatches, full
# remat, the cell's AdamW moments (f32 for these three), the state donated
# as the reference's train cell donates it. Each depth: the dry run of the
# cut cell (`python -m repro_torch.launch.dryrun --arch A --shape train_4k
# --set n_layers=N --set train_microbatches=2 --set-shape global_batch=2`:
# arguments and outputs, the donated state once) plus the f32 gradient sums
# and one microbatch's bf16 gradients (LM_TRAIN_GRAD_BYTES a parameter)
# within LM_TRAIN_BUDGET of the card's 80 GiB. deepseek-v2-lite keeps its
# leading dense layer and four MoE layers.
LM_ARCH_TRAIN_CUT = {"qwen3-8b": 12, "starcoder2-15b": 8, "deepseek-v2-lite-16b": 5}
LM_ARCH_TRAIN_STEPS = 3
LM_TRAIN_GRAD_BYTES = 6
LM_TRAIN_BUDGET = 0.85


# 12f: flash_attention at 12e's train shapes, one 4,096-token sequence:
# (B, Hq, Hkv, S, Dqk, Dv, window, timed calls); and the plain backward at
# MLA's pair, one deepseek-v2-lite train sequence and deepseek-v3's 128
# heads at 1,024 tokens (B, Hq, Hkv, S, Dqk, timed calls, Dv)
LM_ARCH_TRAIN_ATTN = {"qwen3-8b": (1, 32, 8, 4096, 128, 128, None, 5),
                      "starcoder2-15b": (1, 48, 4, 4096, 128, 128, 4096, 5),
                      "deepseek-v2-lite-16b": (1, 16, 16, 4096, 192, 128, None, 5)}
LM_ARCH_ATTN_BWD_SHAPES = [(1, 16, 16, 4096, 192, 3, 128), (1, 128, 128, 1024, 192, 1, 128)]


def phase_attention_train_shapes():
    """12f: the bf16 tensor-core kernel at each train shape of 12e, held to
    the plain version as 6b holds it, timed beside its bound and SDPA (SDPA
    causal: at 4,096 tokens starcoder2's window of 4,096 masks nothing more);
    then the plain backward at MLA's pair (11b's checks and times)."""
    log(f"== phase 12f: flash_attention at the train shapes ({CARD})")
    rows = {}
    for arch, (b, hq, hkv, s, d, dv, window, reps) in LM_ARCH_TRAIN_ATTN.items():
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        q, k, v = ((torch.randn(shape, generator=g, device=DEVICE) * 0.3).to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv)))

        def call():
            return ops.attention(q, k, v, causal=True, window=window)

        got = attention_variant_launches(call, "bf16_tc")
        ok, diffs = attention_checks(got, q, k, v, window=window)
        check(DEVICE != "cuda" or ok, f"flash_attention {arch} train shape differs: {diffs}")
        del got
        r = {"shape": [b, hq, hkv, s, d, dv], "window": window, "dtype": "bfloat16",
             "variant": "bf16_tc", "max_abs_err": diffs["bf16 (ii)"],
             "allowance_used": [diffs["bf16 (i) ratio"], diffs["bf16 (ii) ratio"]],
             "ms": time_ms(call, reps),
             "device_ms": kernel_device_ms(call, reps, "flash_attention"),
             "library_ms": sdpa_ms(q, k, v, reps)}
        cost = attention_cost(b, hq, hkv, s, d, 2, window=window, dv=dv)
        r["bound_ms"], r["bound_by"] = bound(cost, PEAK_BF16_FLOPS_PER_S)
        lib = r["library_ms"]
        log(f"{arch} [{b},{hq}/{hkv},{s},{d}/{dv}]{f' window {window}' if window else ''} "
            f"bf16 causal: {r['ms']:.4f} ms kernel ({r['device_ms']:.4f} ms on the device, "
            f"{r['device_ms'] / r['bound_ms']:.2f}x bound), "
            f"{'not taken' if lib is None else f'{lib:.4f} ms'} SDPA, {r['bound_ms']:.4f} ms "
            f"bound ({r['bound_by']}: {cost[1] / 1e12:.3f} TFLOP); the plain version's "
            f"checks used {diffs['bf16 (i) ratio']:.3g}, {diffs['bf16 (ii) ratio']:.3g} of "
            f"their allowances")
        rows[arch] = r
        del q, k, v
    rows["backward"] = phase_attention_backward(LM_ARCH_ATTN_BWD_SHAPES, phase="12f")
    free_card()
    return rows


@contextlib.contextmanager
def recorded_routing():
    """Every `moe_dispatch` call while open -> a list of (the router's
    storage, the token's smallest gap between its k-th and (k+1)-th router
    probability, (slot, token_of, keep)), in call order."""
    calls = []
    dispatch = transformer.moe_dispatch

    def recording(x2d, router, cfg, dropless=False):
        out = dispatch(x2d, router, cfg, dropless=dropless)
        with torch.no_grad():
            top = torch.topk(torch.softmax(x2d.float() @ router, dim=-1),
                             cfg.top_k + 1, dim=-1).values
            calls.append((router.data_ptr(), (top[:, -2] - top[:, -1]).min(),
                          tuple(o.detach().clone() for o in out[:3])))
        return out

    transformer.moe_dispatch = recording
    try:
        yield calls
    finally:
        transformer.moe_dispatch = dispatch


def recomputed_routing_equal(calls, forwards):
    """Under full remat each microbatch routes every MoE layer in its
    forward and again in the backward's recomputation, before the next
    microbatch starts: `calls` splits into `forwards` equal runs, and within
    a run each router's calls (its groups') into the forward's and the
    recomputation's halves, which must be equal. -> the routers a run."""
    per = len(calls) // forwards
    check(per * forwards == len(calls) and per % 2 == 0,
          f"{len(calls)} router calls in {forwards} microbatches")
    for j in range(forwards):
        by_router = {}
        for ptr, _, out in calls[j * per:(j + 1) * per]:
            by_router.setdefault(ptr, []).append(out)
        for outs in by_router.values():
            h = len(outs) // 2
            check(len(outs) == 2 * h, f"a router called {len(outs)} times in a microbatch")
            for a, b in zip(outs[:h], outs[h:]):
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      "remat's recomputed routing differs from the forward's")
    return len(by_router)


def phase_lm_arch_train_parity(arch, cfg=None, tokens=LM_ARCH_TRAIN_TOKENS):
    """12d: `arch`'s train step card vs CPU at smoke size (f32, the kernel's
    head dims), 2 microbatches and full remat; the routing gap on either
    device, and on the card remat's recomputed routing against the
    forward's."""
    cfg = cfg or serve_cli.serve_config(arch)
    state_dtype = cells.LM_STATE_DTYPE.get(arch, "float32")
    tc = TrainConfig(optimizer=AdamWConfig(state_dtype=state_dtype, **TRAIN_OPT),
                     warmup_steps=1, total_steps=10, microbatches=LM_ARCH_TRAIN_MICRO,
                     remat=True)
    b, s = tokens
    streams = {dev: SyntheticTokenStream(cfg.vocab, b, s, seed=SEED, device=dev)
               for dev in (DEVICE, "cpu")}

    def batch_at(i, dev):
        return streams[dev](i)

    with recorded_routing() as rec:
        launches = train_card_vs_cpu(
            f"12d {cfg.name} (head dims {cfg.hd if cfg.attention != 'mla' else (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)}, "
            f"{b} x {s} tokens, {LM_ARCH_TRAIN_MICRO} microbatches, remat, {state_dtype} moments)",
            Transformer(cfg, device="cpu", seed=SEED), tc, batch_at,
            kernel="flash_attention")
        # the card's steps ran first: its calls precede the CPU's
        split = len(rec) // 2
        calls = {DEVICE: rec[:split], "cpu": rec[split:]}
    res = {"launches": launches["flash_attention"], "state_dtype": state_dtype}
    if cfg.moe:
        gaps = {dev: float(torch.stack([c[1].cpu() for c in v]).min())
                for dev, v in calls.items()}
        routers = recomputed_routing_equal(calls[DEVICE],
                                           TRAIN_STEPS * LM_ARCH_TRAIN_MICRO)
        res.update(min_routing_gap=gaps, routers=routers)
        ties = {dev: g for dev, g in gaps.items() if g <= ROUTING_NEAR_TIE}
        log(f"  routing: the smallest gap between a token's k-th and (k+1)-th router "
            f"probability {gaps}"
            + (f": a tie within {ROUTING_NEAR_TIE} on {sorted(ties)} (hazard (ii))"
               if ties else f", no tie within {ROUTING_NEAR_TIE}")
            + f"; remat's recomputed routing equal to the forward's at each of "
              f"{routers} routers, every microbatch")
    return res


def lm_train_config(arch):
    return dataclasses.replace(get_arch(arch).CONFIG, n_layers=LM_ARCH_TRAIN_CUT[arch])


@contextlib.contextmanager
def no_sync_in_moe():
    """Sync debug mode "error" inside every MoE block while open (the
    forward and remat's recomputation): a device-to-host read there raises."""
    block = Transformer._moe_block

    def guarded(self, p, x2d, dropless=False, lp=None):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return block(self, p, x2d, dropless, lp)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    Transformer._moe_block = guarded
    try:
        yield
    finally:
        Transformer._moe_block = block


def f32_first_loss(model, batch, micro):
    """The mean over the microbatches of `loss` on the same weights in f32,
    without gradients: what 12e's first bf16 step is held to."""
    m32 = copy.deepcopy(model).float()
    k = batch["tokens"].shape[0] // micro
    with torch.no_grad():
        losses = [m32.loss({n: v[i * k:(i + 1) * k] for n, v in batch.items()})[0]
                  for i in range(micro)]
    loss = float(torch.stack(losses).mean())
    del m32, losses
    free_card()
    return loss


def phase_lm_arch_train_full(arch, cfg=None, seq=None, batch=LM_TRAIN_BATCH,
                             micro=LM_TRAIN_MICRO, steps=LM_ARCH_TRAIN_STEPS):
    """12e: `arch` training at full width in bf16, cut in depth (11d's
    step): the dry run's reckoning of the cut beside the measured peak,
    seconds and tokens/s a step, finite losses, the first held to the same
    weights' f32 loss, flash_attention's launches (2 x microbatches x
    layers a step, half inside the backward, all bf16_tc, no plain forward),
    no device-to-host read inside an MoE layer, and the busy share over one
    more step."""
    cfg = cfg or lm_train_config(arch)
    seq = seq or get_arch(arch).SHAPES[LM_TRAIN_SHAPE].seq_len
    n = cfg.n_layers
    state_dtype = cells.LM_STATE_DTYPE.get(arch, "float32")
    log(f"== phase 12e: {cfg.name} training at full width, cut to {n} of "
        f"{get_arch(arch).CONFIG.n_layers} layers"
        f"{f' ({cfg.first_dense_layers} dense + {n - cfg.first_dense_layers} MoE of {cfg.n_routed} experts top-{cfg.top_k}, {cfg.n_shared} shared)' if cfg.moe else ''}"
        f", d_model {cfg.d_model}, {cfg.attention}, {cfg.dtype} parameters, {state_dtype} "
        f"moments: {LM_TRAIN_SHAPE} cut to {batch} = {micro} microbatches of "
        f"{batch // micro} x {seq} tokens, remat=True, the state donated, {steps} steps ({CARD})")
    res = {"n_layers": n, "n_params": cfg.n_params()}
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, LM_TRAIN_SHAPE, 1, out_dir=None,
                          cfg_overrides={**dataclasses.asdict(cfg), "train_microbatches": micro},
                          shape_overrides={"global_batch": batch, "seq_len": seq})
    args_gib = rec["memory"]["arguments_and_outputs_gib"]
    res["reckoned_gib"] = args_gib + LM_TRAIN_GRAD_BYTES * cfg.n_params() / 2**30
    log(f"dry run of the cut cell ({time.perf_counter() - t0:.1f} s on the host): "
        f"arguments and outputs {args_gib:.3f} GiB + {LM_TRAIN_GRAD_BYTES} bytes x "
        f"{cfg.n_params()} parameters of gradients = {res['reckoned_gib']:.3f} GiB "
        f"reckoned, {100 * res['reckoned_gib'] / 80:.1f}% of 80 GiB")
    check(res["reckoned_gib"] <= LM_TRAIN_BUDGET * 80,
          f"the cut reckons at {res['reckoned_gib']:.1f} GiB, over "
          f"{LM_TRAIN_BUDGET:.0%} of 80 GiB")
    free_card()
    t0 = time.perf_counter()
    model = Transformer(cfg, device=DEVICE, seed=SEED)
    sync()
    res["init_s"] = time.perf_counter() - t0
    stream = SyntheticTokenStream(cfg.vocab, batch, seq, seed=SEED, device=DEVICE)
    t0 = time.perf_counter()
    res["f32_first_loss"] = f32_first_loss(model, stream(0), micro)
    log(f"random weights made on the device in {res['init_s']:.2f} s; the first batch's "
        f"loss on the same weights in f32, no gradients: {res['f32_first_loss']:.6f} "
        f"({time.perf_counter() - t0:.2f} s)")
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-4, state_dtype=state_dtype),
                     microbatches=micro, remat=True, warmup_steps=1, total_steps=steps)
    state, step = init_train_state(model, tc), build_train_step(model, tc, donate=True)
    reset_peak()
    registry.reset_launches()
    times, losses = [], []
    for i in range(steps):
        guard = no_sync_in_moe() if cfg.moe and i == 1 and DEVICE == "cuda" \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with guard:
            state, met = step(state, stream(i))
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
        log(f"  step {i}: {times[-1]:.3f} s, loss {losses[-1]:.6f}, grad_norm "
            f"{float(met['grad_norm']):.4f}"
            + (" (sync debug mode \"error\" inside each MoE layer: no host read)"
               if cfg.moe and i == 1 and DEVICE == "cuda" else ""))
    launches = registry.launch_counts()["flash_attention"]
    recomputed = registry.backward_launch_counts()["flash_attention"]
    variants = registry.variant_counts("flash_attention")
    plain = plain_calls_on_card()
    res.update(step_s=float(np.median(times[1:] or times)), losses=losses,
               launches_per_step=launches / steps, recomputed_per_step=recomputed / steps,
               variants=variants, plain_calls=plain, peak_gib=peak_gib(),
               reserved_gib=(torch.cuda.max_memory_reserved() / 2**30
                             if DEVICE == "cuda" else 0.0))
    res["tokens_per_s"] = batch * seq / res["step_s"]
    check(all(np.isfinite(losses)), f"losses not finite: {losses}")
    res["first_loss_rel"] = abs(losses[0] - res["f32_first_loss"]) / abs(res["f32_first_loss"])
    check(res["first_loss_rel"] <= LM_PARITY_TOL,
          f"the first bf16 step's loss {losses[0]:.6f} is {res['first_loss_rel']:.3g} "
          f"from the f32 loss {res['f32_first_loss']:.6f}, over {LM_PARITY_TOL}")
    want = micro * n
    if DEVICE == "cuda":
        check(launches == steps * 2 * want and recomputed == steps * want,
              f"flash_attention launched {launches} times in {steps} steps, "
              f"{recomputed} of them in the backward; expected {2 * want} a step, "
              f"{want} of them in the backward")
        check(variants["bf16_tc"] == launches,
              f"launches by variant {variants}: all must be the tensor-core kernel")
        check(not plain, f"plain calls on the card: {plain}")
    log(f"median step {res['step_s']:.3f} s (steps 1-{steps - 1}), {res['tokens_per_s']:.0f} "
        f"tokens/s; the first loss {losses[0]:.6f} against f32 {res['f32_first_loss']:.6f} "
        f"(relative {res['first_loss_rel']:.3g}, tolerance {LM_PARITY_TOL}); "
        f"max_memory_allocated {res['peak_gib']:.3f} GiB, reserved {res['reserved_gib']:.3f} "
        f"GiB against {res['reckoned_gib']:.3f} GiB reckoned; "
        f"flash_attention {res['launches_per_step']:.0f} launches a step, "
        f"{res['recomputed_per_step']:.0f} of them inside the backward ({micro} microbatches "
        f"x {n} layers), by variant {variants}, plain calls {plain}")
    batch0 = stream(steps + 2)
    res["device_ms_per_step"] = profile_device(lambda: step(state, batch0), 1,
                                               "train step", "flash_attention")
    del model, state, step, stream, batch0
    free_card()
    return res


def run_lm_archs():
    """Phase 12 -> its fields of the flash_attention entry of the JSON line:
    the MLA pair's checks and times, and each arch's runs."""
    t0 = time.perf_counter()
    mla = phase_attention_mla()
    parity = {arch: phase_lm_arch_parity(arch) for arch in LM_ARCHS}
    free_card()
    full = {}
    for arch in LM_ARCHS:
        full[arch] = phase_lm_arch_full(arch)
        if arch == "starcoder2-15b":
            full[arch]["ring_past_window_max_abs_err"] = phase_ring_past_window()
            free_card()
    log("== phase 12d: the train step card vs CPU at smoke size "
        f"({TRAIN_STEPS} steps from one state; losses rtol {TRAIN_LOSS_TOL}, parameters "
        f"atol {TRAIN_PARAM_TOL} but for {TRAIN_FLIP_SHARE} of a leaf; {CARD})")
    train_parity = {arch: phase_lm_arch_train_parity(arch) for arch in LM_ARCHS}
    free_card()
    train_full = {arch: phase_lm_arch_train_full(arch) for arch in LM_ARCH_TRAIN_CUT}
    train_shapes = phase_attention_train_shapes()
    log(f"phase 12: {time.perf_counter() - t0:.1f} s ({CARD})")
    return {"mla": {"tolerance": ATTN_TOLERANCE, **mla},
            "launches_lm_archs": {a: {"prefill_32k": r["prefill_32k"]["launches"],
                                      "serve": r["serve"]["launches"]}
                                  for a, r in full.items()},
            "launches_train_lm_archs": {
                a: {"parity_steps": r["launches"],
                    **({"train_step": train_full[a]["launches_per_step"],
                        "inside_backward": train_full[a]["recomputed_per_step"]}
                       if a in train_full else {})}
                for a, r in train_parity.items()},
            "train_shapes": train_shapes,
            "lm_archs": {"parity": parity, "full": full,
                         "train_parity": train_parity, "train_full": train_full}}


# ------------------- phase 13: the sharded PNA, the dry run, counts on the card
# 13a: pna at full width (4 layers, d_hidden 75) over the edge partition on
# the sim backend. full_graph_sm: an Erdos-Renyi graph of the shape's 2,708
# vertices and 10,556 arcs (d_feat 1,433, 7 classes), at P in PNA_SHARDS,
# f32 and bf16 messages: the losses on the uncut graph, then the loss and
# the gradients with the vertices of fewer than PNA_MIN_DEGREE edges
# stripped of them (min_degree_core), then PNA_STEPS AdamW steps (weight
# decay 0, as the reference's cell). Stripped at 2 (11a's graph: no vertex
# of one edge, whose variance is 0 and its gradient a tie's), the port's f32
# gradients move 0.08-0.31% relative L2 under a 1e-7 change of the weights
# or from one CPU run to the next, the reference's 0.10-0.13%
# (tools/pna_conditioning.py, tools/pna_conditioning_reference.py), since
# the variance is rounded once as XLA's FMA rounds it
# (`graph/segment_ops.mean_and_std`); but that is the f32 bound's size, and
# card vs CPU read 1.21e-3 at P = 4 in PR 23's first chip run. So the
# gradients are held stripped at 3 (at most 0.03%), and the readings at
# PNA_FINDING_DEGREE are printed beside them, held to nothing.
PNA_MIN_DEGREE = 3
PNA_FINDING_DEGREE = 2
PNA_SHARDS = (2, 4)
PNA_STEPS = 3
PNA_OPT = dict(lr=1e-4, weight_decay=0.0)
# The gradients are held leaf by leaf in relative L2, (loss rtol, gradient
# bound) per comparison, not entry by entry: on this graph a 1e-7 change of
# the weights moves single entries past the CPU tests' tolerance in both
# packages (the reference's own gradient: 14.3x that tolerance, 0.14%
# relative L2; the port's: up to 4x, 0.03%), while a wrong term moves a
# whole leaf. Each bound stands at about 3x the largest card reading of PR
# 22's chip runs: f32 card vs CPU 1.5-3.5e-4 and sharded vs local up to
# 3.1e-4; bf16 messages card vs CPU 1.0-1.2e-3, against the f32 local loss
# (the rounding itself, 2^-9 of every message) 0.0170-0.0172.
PNA_F32_TOL = (TRAIN_LOSS_TOL, 1e-3)
PNA_BF16_VS_CPU = (1e-3, 4e-3)
PNA_BF16_LOCAL = (5e-3, 0.05)
# the steps' update (parameters after less before) card vs CPU, leaf by
# leaf in relative L2. 11a's per-entry rule does not hold at full width: a
# few hundred of the first layer's 1,397,175 weights have a gradient below
# the card-vs-CPU noise, which Adam turns into steps of a few lr of either
# sign. Sound readings: card vs CPU 0.0209 and 0.0258 (PR 22's chip runs),
# a 1e-7 change of the weights on the CPU 0.027-0.053; planted faults on
# the CPU: a layer's gradient dropped 1.0, bf16 messages in place of f32
# 0.23 (tools/pna_conditioning.py --faults). About 3x the largest sound
# reading, below every fault's.
PNA_UPDATE_REL = 0.15
# ogb_products at full width (d_feat 100, 47 classes, pna's widths): the
# step at P = 2 on the sim keeps both shards' activations on the one card.
# `pna_step_gib` reckons the peak from the tensors the step keeps for its
# backward, and the graph is cut to the largest number of vertices (at the
# shape's mean degree) whose reckoning is OGB_BUDGET_GIB, with the
# partition's slots at OGB_SLOT_PAD x its arcs (1.0998 at P = 2, measured);
# the card measured 1.06x the reckoning (61.6 GiB at 58.0), so the peak
# lands under 60 GiB (PR 22's chip runs)
OGB_BUDGET_GIB = 56.0
OGB_SLOT_PAD = 1.1
# 13b: the dry run over every cell in its own process, DRYRUN_JOBS workers,
# started before 13a and read after it
DRYRUN_JOBS = 4
DRYRUN_TIMEOUT_S = 600
# 13c: cells on the card, under the counter: (arch, shape, chips, config
# overrides, shape overrides); qwen2's prefill_32k cut to one sequence (6d)
CELLS_ON_CARD = (
    ("qwen2-1.5b", "prefill_32k", 1, {}, {"global_batch": 1}),
    ("graphsage-reddit", "minibatch_lg", 1, {}, {}),
    ("bert4rec", "retrieval_cand", 1, {}, {}),
    ("pna", "full_graph_sm", 2, {"distributed": True}, {}),
)
CELL_REPS = 3


def local_pna_grads(model, batch):
    """(loss, gradient leaves in the JAX tree's order) of the local PNA."""
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss, _ = gnn_mod.loss_fn(model, batch)
        gs = torch.autograd.grad(loss, list(named.values()))
    finally:
        model.requires_grad_(False)
    return float(loss), leaves(nest(dict(zip(named, gs)), model.param_paths()))


def sharded_pna_grads(cfg, prims, n_local, params, batch):
    """(loss, gradient leaves) of the sharded PNA loss."""
    xs = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
    loss, _ = gd.build_distributed_pna_loss(cfg, prims, n_local)(
        unflatten(params, xs), batch)
    return float(loss), list(torch.autograd.grad(loss, xs))


def grads_rel(got, want):
    """The largest relative L2 difference of a leaf."""
    return max(float((a.float().cpu() - b.float().cpu()).norm())
               / max(float(b.float().cpu().norm()), 1e-30) for a, b in zip(got, want))


def grads_entry_excess(got, want):
    """The largest entry's |got - want| over 1e-6 + 1e-4 x its leaf's
    largest |want| (the CPU tests' tolerance), for the record."""
    return max(float(((a.float().cpu() - b.float().cpu()).abs()
                      / (1e-6 + 1e-4 * float(b.float().cpu().abs().max()))).max())
               for a, b in zip(got, want))


def local_batch(g, batch, feats, dev):
    """The partitioned batch's vertices by global id, for the local model."""
    nl = batch["x"].shape[1]
    ids = torch.arange(g.n)
    rows, cols = ids // nl, ids % nl
    return {"x": torch.from_numpy(feats).to(dev),
            "src": torch.from_numpy(g.src.astype(np.int64)).to(dev),
            "dst": torch.from_numpy(g.dst.astype(np.int64)).to(dev),
            "labels": batch["labels"].cpu()[rows, cols].long().to(dev),
            "train_mask": batch["train_mask"].cpu()[rows, cols].to(dev),
            "log_deg_avg": batch["log_deg_avg"].to(dev)}


def to_dev(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def pna_uncut_losses(cfg, shape, n_classes, g0, model_card, params):
    """13a's losses on the uncut graph: card vs CPU vs the local loss on the
    card, at P in PNA_SHARDS, f32 and bf16 messages, within the gradient
    checks' loss tolerances (a forward: the degree-one ties move only the
    gradients)."""
    rows = []
    with torch.no_grad():
        local = None
        for P in PNA_SHARDS:
            batch_cpu, feats, part = gd.partitioned_batch_from_graph(
                g0, shape.d_feat, n_classes, P, seed=SEED, device="cpu")
            batches = {"cpu": batch_cpu, DEVICE: to_dev(batch_cpu, DEVICE)}
            if local is None:
                local = float(gnn_mod.loss_fn(
                    model_card, local_batch(g0, batch_cpu, feats, DEVICE))[0])
            for mdt in ("float32", "bfloat16"):
                c = dataclasses.replace(cfg, message_dtype=mdt)
                lc, lp = (float(gd.build_distributed_pna_loss(c, sim_prims(P, dev),
                                                              part.n_local)(
                    params[dev], batches[dev])[0]) for dev in (DEVICE, "cpu"))
                tol_cpu, tol_local = ((PNA_F32_TOL[0], PNA_F32_TOL[0]) if mdt == "float32"
                                      else (PNA_BF16_VS_CPU[0], PNA_BF16_LOCAL[0]))
                check(abs(lc - lp) <= tol_cpu * abs(lp)
                      and abs(lc - local) <= tol_local * abs(local),
                      f"13a uncut P={P} {mdt}: loss card {lc}, CPU {lp}, local {local}")
                rows.append({"P": P, "message_dtype": mdt, "loss": lc, "loss_cpu": lp,
                             "loss_local": local})
    log(f"uncut ({g0.m} arcs): losses card / CPU / local "
        + "; ".join(f"P={r['P']} {r['message_dtype']} {r['loss']:.6f} / "
                    f"{r['loss_cpu']:.6f} / {r['loss_local']:.6f}" for r in rows))
    return rows


def phase_sharded_pna_parity():
    """13a(i)-(iii): full_graph_sm, card == CPU == local at P = 2 and 4 in
    f32 and bf16, PNA_STEPS AdamW steps card vs CPU, and the spmd backend
    on one NCCL rank against the sim at P = 1."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_shard_group

    cfg = get_arch("pna").CONFIG
    shape = get_arch("pna").SHAPES["full_graph_sm"]
    n_classes = GNN_CLASSES["full_graph_sm"]
    g0 = gen.erdos_renyi_graph(shape.n_nodes, shape.n_edges / shape.n_nodes, seed=SEED,
                               n_labels=n_classes)
    g = min_degree_core(g0, PNA_MIN_DEGREE)
    log(f"== phase 13a: sharded PNA ({cfg.n_layers} layers, d_hidden {cfg.d_hidden}) "
        f"on full_graph_sm: {g.n} vertices, {g0.m} arcs, {g.m} once the vertices of "
        f"fewer than {PNA_MIN_DEGREE} lose theirs, d_feat {shape.d_feat}, {n_classes} "
        f"classes; card vs CPU vs the local loss ({CARD})")
    model_cpu = GNN(cfg, shape.d_feat, n_classes, device="cpu", seed=SEED)
    model_card = copy.deepcopy(model_cpu).to(DEVICE)
    params = {"cpu": param_tree(model_cpu), DEVICE: param_tree(model_card)}
    uncut = pna_uncut_losses(cfg, shape, n_classes, g0, model_card, params)
    rows = []
    local = None
    for P in PNA_SHARDS:
        batch_cpu, feats, part = gd.partitioned_batch_from_graph(
            g, shape.d_feat, n_classes, P, seed=SEED, device="cpu")
        batches = {"cpu": batch_cpu, DEVICE: to_dev(batch_cpu, DEVICE)}
        if local is None:
            local = local_pna_grads(model_card, local_batch(g, batch_cpu, feats, DEVICE))
        for mdt in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, message_dtype=mdt)
            out = {dev: sharded_pna_grads(c, sim_prims(P, dev), part.n_local,
                                          params[dev], batches[dev])
                   for dev in (DEVICE, "cpu")}
            (lc, gc), (lp, gp) = out[DEVICE], out["cpu"]
            (l_cpu, g_cpu), (l_local, g_local) = (
                (PNA_F32_TOL, PNA_F32_TOL) if mdt == "float32"
                else (PNA_BF16_VS_CPU, PNA_BF16_LOCAL))
            vs_cpu, vs_local = grads_rel(gc, gp), grads_rel(gc, local[1])
            check(abs(lc - lp) <= l_cpu * abs(lp) and vs_cpu <= g_cpu,
                  f"13a P={P} {mdt}: card vs CPU loss {lc} vs {lp}, gradients "
                  f"{vs_cpu:.3g} apart (relative L2, bound {g_cpu})")
            check(abs(lc - local[0]) <= l_local * abs(local[0]) and vs_local <= g_local,
                  f"13a P={P} {mdt}: sharded vs local loss {lc} vs {local[0]}, "
                  f"gradients {vs_local:.3g} apart (relative L2, bound {g_local})")
            log(f"P={P} {mdt} messages: loss card {lc:.6f}, CPU {lp:.6f}, local "
                f"{local[0]:.6f}; gradients' relative L2 card vs CPU {vs_cpu:.3g} "
                f"(bound {g_cpu}; the largest entry "
                f"{grads_entry_excess(gc, gp):.3g}x the CPU tests' tolerance), vs "
                f"local {vs_local:.3g} (bound {g_local}) (B {part.B}, slots "
                f"{P * P * part.B})")
            rows.append({"P": P, "message_dtype": mdt, "loss": lc,
                         "grads_rel_vs_cpu": vs_cpu, "grads_rel_vs_local": vs_local})
    # PNA_STEPS AdamW steps card vs CPU at P = 2, f32
    P = PNA_SHARDS[0]
    batch_cpu, _, part = gd.partitioned_batch_from_graph(
        g, shape.d_feat, n_classes, P, seed=SEED, device="cpu")
    opt = AdamWConfig(**PNA_OPT)
    runs = {}
    for dev, b in ((DEVICE, to_dev(batch_cpu, DEVICE)), ("cpu", batch_cpu)):
        step = gd.build_distributed_pna_step(cfg, sim_prims(P, dev),
                                             part.n_local, opt)
        state = {"params": params[dev], "opt": adamw.init_state(params[dev], opt),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        losses = []
        for _ in range(PNA_STEPS):
            state, met = step(state, b)
            losses.append(float(met["loss"]))
        runs[dev] = (losses, state)
    (lc, sc), (lp, sp) = runs[DEVICE], runs["cpu"]
    check(np.allclose(lc, lp, rtol=TRAIN_LOSS_TOL, atol=0),
          f"13a: AdamW losses differ card vs CPU: {lc} vs {lp}")
    start = leaves(params["cpu"])
    upd = {dev: [a.float().cpu() - b for a, b in zip(leaves(s["params"]), start)]
           for dev, s in ((DEVICE, sc), ("cpu", sp))}
    rel_upd = grads_rel(upd[DEVICE], upd["cpu"])
    diff = torch.cat([(a - b).reshape(-1) for a, b in zip(upd[DEVICE], upd["cpu"])])
    n_upd = sum(t.numel() for t in upd["cpu"])
    beyond = int((diff.abs() > TRAIN_PARAM_TOL).sum())
    check(rel_upd <= PNA_UPDATE_REL, f"13a: the AdamW update differs card vs CPU by "
                                     f"{rel_upd:.3g} (the largest leaf's relative L2)")
    log(f"{PNA_STEPS} AdamW steps at P={P}: losses {[round(x, 6) for x in lc]} (CPU "
        f"{[round(x, 6) for x in lp]}); the update card vs CPU {rel_upd:.3g} apart "
        f"(the largest leaf's relative L2, bound {PNA_UPDATE_REL}; {beyond} of {n_upd} "
        f"entries past {TRAIN_PARAM_TOL}, the largest {float(diff.abs().max()):.3g})")
    # spmd on one NCCL rank (NCCL takes one rank a GPU) against the sim at P = 1
    batch1, _, part1 = gd.partitioned_batch_from_graph(
        g, shape.d_feat, n_classes, 1, seed=SEED, device=DEVICE)
    sim1 = sharded_pna_grads(cfg, sim_prims(1, DEVICE), part1.n_local,
                             params[DEVICE], batch1)
    with tempfile.TemporaryDirectory() as d:
        group = make_shard_group(1, backend="nccl", rank=0,
                                 init_method=f"file://{d}/rendezvous")
        try:
            spmd = sharded_pna_grads(cfg, gd.spmd_gnn_prims(group, 1, 0, DEVICE),
                                     part1.n_local, params[DEVICE], batch1)
        finally:
            dist.destroy_process_group()
    rel = grads_rel(spmd[1], sim1[1])
    check(abs(spmd[0] - sim1[0]) <= PNA_F32_TOL[0] * abs(sim1[0]) and rel <= PNA_F32_TOL[1],
          f"13a: spmd on one NCCL rank differs from the sim at P=1 ({spmd[0]} vs "
          f"{sim1[0]}, gradients {rel:.3g} apart)")
    log(f"spmd (nccl, 1 rank): loss {spmd[0]:.6f}, sim P=1 {sim1[0]:.6f}; gradients' "
        f"relative L2 {rel:.3g}")
    return {"graph": {"n": g.n, "m": g.m, "m_before_cut": g0.m}, "uncut_losses": uncut,
            "parity": rows, "adamw_losses": lc, "adamw_update_rel": rel_upd,
            "finding_degree": pna_finding_readings(cfg, shape, n_classes, g0,
                                                   model_card, params)}


def pna_finding_readings(cfg, shape, n_classes, g0, model_card, params):
    """13a's f32 readings with the vertices of fewer than PNA_FINDING_DEGREE
    edges stripped: gradients card vs CPU and vs the local loss at each P,
    printed as a finding and held to nothing (PNA_MIN_DEGREE)."""
    g = min_degree_core(g0, PNA_FINDING_DEGREE)
    out = []
    local = None
    for P in PNA_SHARDS:
        batch_cpu, feats, part = gd.partitioned_batch_from_graph(
            g, shape.d_feat, n_classes, P, seed=SEED, device="cpu")
        if local is None:
            local = local_pna_grads(model_card, local_batch(g, batch_cpu, feats, DEVICE))
        grads = {dev: sharded_pna_grads(cfg, sim_prims(P, dev), part.n_local, params[dev],
                                        b)[1]
                 for dev, b in ((DEVICE, to_dev(batch_cpu, DEVICE)), ("cpu", batch_cpu))}
        out.append({"P": P, "grads_rel_vs_cpu": grads_rel(grads[DEVICE], grads["cpu"]),
                    "grads_rel_vs_local": grads_rel(grads[DEVICE], local[1])})
    readings = "; ".join(f"P={r['P']}: card vs CPU {r['grads_rel_vs_cpu']:.3g}, vs local "
                         f"{r['grads_rel_vs_local']:.3g}" for r in out)
    log(f"finding, held to nothing: stripped at {PNA_FINDING_DEGREE} ({g.m} arcs), the f32 "
        f"gradients' relative L2 {readings} (the bound at {PNA_MIN_DEGREE}: "
        f"{PNA_F32_TOL[1]})")
    return out


def pna_step_gib(cfg, n, slots, d_feat, d_out):
    """The reckoned peak of one sharded PNA train step (f32 messages, every
    shard on one card): per layer of input width F, the tensors kept for the
    backward -- per vertex the [13F] concatenation the layer's product reads,
    about 9F of aggregates, masks and scaled copies, the layer's output; per
    slot the received messages and the two where-filled copies the min and
    max read (3F), two int64 indices -- and at the start of the backward
    the gradient of the last concatenation and of one layer's messages."""
    widths = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
    per_vertex = sum(22 * f + cfg.d_hidden for f in widths) + 13 * max(widths) + d_out
    per_slot = sum(3 * f + 4 for f in widths) + 3 * max(widths)
    return 4 * (n * per_vertex + slots * per_slot) / 2**30


def exchange_timer(prims):
    """`prims` with each exchange (a transpose on the sim, its own transpose
    in the backward) timed by CUDA events -> (prims, the list of event
    pairs)."""
    events = []
    base = prims.exchange

    def timed_exchange(x):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = base(x)
        stop.record()
        events.append((start, stop))
        return out

    class _Timed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return timed_exchange(x)

        @staticmethod
        def backward(ctx, grad):
            return timed_exchange(grad)

    return prims._replace(exchange=_Timed.apply), events


def phase_sharded_pna_full():
    """13a(iv): ogb_products at full width, cut to fit the card at P = 2 on
    the sim: a step's ms at P = 2 and at P = 1 (the local model), peak
    memory, the exchange's share of the P = 2 step."""
    cfg = get_arch("pna").CONFIG
    shape = get_arch("pna").SHAPES["ogb_products"]
    n_classes = GNN_CLASSES["ogb_products"]
    degree = shape.n_edges / shape.n_nodes
    full = pna_step_gib(cfg, shape.n_nodes, shape.n_edges, shape.d_feat, n_classes)
    n = shape.n_nodes
    while pna_step_gib(cfg, n, int(n * degree * OGB_SLOT_PAD), shape.d_feat,
                       n_classes) > OGB_BUDGET_GIB:
        n = int(n * 0.95)
    t0 = time.perf_counter()
    g = min_degree_core(gen.erdos_renyi_graph(n, degree, seed=SEED, n_labels=n_classes),
                        PNA_MIN_DEGREE)
    batch, feats, part = gd.partitioned_batch_from_graph(
        g, shape.d_feat, n_classes, 2, seed=SEED, device=DEVICE)
    host_s = time.perf_counter() - t0
    slots = 2 * 2 * part.B
    reckoned = pna_step_gib(cfg, g.n, slots, shape.d_feat, n_classes)
    log(f"== phase 13a: ogb_products at full width (d_feat {shape.d_feat}, "
        f"{n_classes} classes), P=2 on the sim ({CARD}): the whole graph "
        f"({shape.n_nodes} vertices, {shape.n_edges} arcs) reckons at {full:.1f} GiB; "
        f"cut to {g.n} vertices and {g.m} arcs (mean degree {degree:.2f}), "
        f"{slots} slots, reckoned {reckoned:.1f} GiB (graph and partition "
        f"{host_s:.1f} s on the host)")
    opt = AdamWConfig(**PNA_OPT)
    model = GNN(cfg, shape.d_feat, n_classes, device=DEVICE, seed=SEED)
    params = param_tree(model)
    state = {"params": params, "opt": adamw.init_state(params, opt),
             "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}
    res = {"n": g.n, "m": g.m, "slots": slots, "reckoned_gib": reckoned,
           "full_graph_reckoned_gib": full}
    step = gd.build_distributed_pna_step(cfg, sim_prims(2, DEVICE),
                                         part.n_local, opt)
    free_card()
    reset_peak()
    out = step(state, batch)
    sync()
    res["p2_peak_gib"] = peak_gib()
    check(np.isfinite(float(out[1]["loss"])), "13a: the P=2 step's loss is not finite")
    res["p2_ms"] = time_ms(lambda: step(state, batch), 2)
    if DEVICE != "cuda":  # a rehearsal on the CPU: no device time exists
        return res
    timed_prims, events = exchange_timer(sim_prims(2, DEVICE))
    tstep = gd.build_distributed_pna_step(cfg, timed_prims, part.n_local, opt)
    tstep(state, batch)
    sync()
    events.clear()
    t_ms = time_ms(lambda: tstep(state, batch), 1)
    # time_ms ran the step twice (a warm-up and the timed call)
    res["exchange_ms"] = sum(a.elapsed_time(b) for a, b in events) / 2
    res["exchange_share"] = res["exchange_ms"] / t_ms
    log(f"P=2 step {res['p2_ms']:.2f} ms, loss {float(out[1]['loss']):.4f}, peak "
        f"{res['p2_peak_gib']:.2f} GiB (reckoned {reckoned:.1f}); the exchange "
        f"{res['exchange_ms']:.2f} ms a step ({len(events) // 2} transposes: one a "
        f"layer, and the transpose of each but the first in the backward), "
        f"{100 * res['exchange_share']:.1f}% of it")
    del out, step, tstep, batch
    free_card()
    gb = full_graph_batch(g, shape.d_feat, n_classes, seed=SEED, device=DEVICE)
    tc = TrainConfig(optimizer=opt)
    lstate, lstep = init_train_state(model, tc), build_train_step(model, tc)
    reset_peak()
    lout = lstep(lstate, gb)
    sync()
    res["p1_peak_gib"] = peak_gib()
    res["p1_ms"] = time_ms(lambda: lstep(lstate, gb), 2)
    log(f"P=1 (the local model): step {res['p1_ms']:.2f} ms, loss "
        f"{float(lout[1]['loss']):.4f}, peak {res['p1_peak_gib']:.2f} GiB; "
        f"P=2 / P=1 {res['p2_ms'] / res['p1_ms']:.2f}x")
    del lout, lstate, gb, model
    free_card()
    return res


def start_dryrun(out_dir):
    """13b: `python -m repro_torch.launch.dryrun` over every cell on the
    meta device, in its own process (its records in out_dir)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--jobs",
           str(DRYRUN_JOBS), "--out", out_dir]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT), time.perf_counter()


def finish_dryrun(started):
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    lines = out.strip().splitlines()
    log(f"== phase 13b: the dry run of every cell on the meta device "
        f"({DRYRUN_JOBS} worker processes, {time.perf_counter() - t0:.1f} s since "
        f"it started)")
    for line in lines:
        log(line)
    check(proc.returncode == 0, f"the dry run failed ({proc.returncode}): {err[-3000:]}")
    ok = sum(line.startswith("[ok]") for line in lines)
    skipped = sum(line.startswith("[skipped]") for line in lines)
    return {"cells_ok": ok, "cells_skipped": skipped}


def expected_kernel_work(arch, shape_name, cell):
    """Each hand-written kernel's (calls, bytes, operations) in one run of
    the cell, from `kernels/cost.py` and the cell's shapes."""
    mod = get_arch(arch)
    cfg, shape = mod.CONFIG, mod.SHAPES[shape_name]
    if arch == "qwen2-1.5b":
        b, s = cell.args[1].shape
        c = attention_cost(b, cfg.n_heads, cfg.n_kv_heads, s, cfg.hd, 2)
        return {"flash_attention": (cfg.n_layers, cfg.n_layers * c[0], cfg.n_layers * c[1])}
    if arch == "graphsage-reddit":
        calls = [segment_agg_cost(nt, d, f, 4) for nt, d, f in agg_shapes(shape, cfg)]
        return {"segment_agg": (3, sum(c[0] for c in calls), sum(c[1] for c in calls))}
    if arch == "bert4rec":
        n = shape.n_candidates
        c = embedding_bag_cost(n, 1, cfg.embed_dim, 2, min(n, cfg.n_items + 2))
        return {"embedding_bag": (1, c[0], c[1])}
    return {}


def phase_cells_on_card():
    """13c: four cells on the card under the counter: measured ms, the
    counted roofline bound, the share of the bf16 peak on model FLOPs, the
    counter's FLOPs and bytes beside the profiler's."""
    from torch.profiler import ProfilerActivity, profile

    log(f"== phase 13c: cells on the card under the cost counter ({CARD})")
    rows = []
    for arch, shape_name, chips, cfg_o, shape_o in CELLS_ON_CARD:
        cell = cells.build_cell(arch, shape_name, chips=chips, cfg_overrides=cfg_o,
                                shape_overrides=shape_o, device=DEVICE, seed=SEED)
        cell()
        sync()
        registry.reset_launches()
        counted = counted_step(cell)
        with OpCounter() as counter:
            counted(*cell.args)
            sync()
        launches = {k: v for k, v in registry.launch_counts().items() if v}
        summary = counter.summary()
        ms = time_ms(cell, CELL_REPS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            cell()
            sync()
        prof_flops = sum(e.flops for e in prof.key_averages())
        prof_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
        # one card runs every shard of the cell: its whole count is the card's
        rl = Roofline(arch=arch, shape=shape_name, mesh="one_card", chips=1,
                      flops_tc_per_device=summary["flops_tc"],
                      flops_f32_per_device=summary["flops_f32"],
                      bytes_per_device=summary["bytes"],
                      collective_bytes_per_device=0.0,
                      model_flops=cell.model_flops_fn())
        share = cell.model_flops_fn() / (ms * 1e-3 * PEAK_BF16_FLOPS_PER_S)
        want = expected_kernel_work(arch, shape_name, cell)
        got = {k: (v["calls"], v["bytes"], v["operations"])
               for k, v in summary["kernels"].items()}
        check(got == want, f"13c {arch} {shape_name}: counted kernel work {got}, "
                           f"kernels/cost.py gives {want}")
        for name in want:
            check(DEVICE != "cuda" or launches.get(name, 0) == want[name][0],
                  f"13c {arch} {shape_name}: {name} launched "
                  f"{launches.get(name, 0)} times, expected {want[name][0]}")
        check(DEVICE != "cuda" or share <= 1.0,
              f"13c {arch} {shape_name}: share {share:.3f} over 1")
        kernel_flops = sum(v["operations"] for v in summary["kernels"].values())
        row = {"arch": arch, "shape": shape_name, "ms": ms,
               "bound_ms": rl.bound_s * 1e3, "bottleneck": rl.bottleneck,
               "share": share, "model_flops": cell.model_flops_fn(),
               "counted_flops": summary["flops"], "counted_bytes": summary["bytes"],
               "profiler_flops": prof_flops, "profiler_device_ms": prof_ms,
               "launches": launches}
        rows.append(row)
        log(f"{arch} {shape_name}{' ' + str(shape_o) if shape_o else ''}"
            f"{' ' + str(cfg_o) if cfg_o else ''}: {ms:.3f} ms, counted bound "
            f"{row['bound_ms']:.3f} ms ({rl.bottleneck}; {ms / row['bound_ms']:.2f}x), "
            f"share of the bf16 peak on model FLOPs {share:.4f}; counted "
            f"{summary['flops']:.4e} FLOPs ({kernel_flops:.4e} in our kernels, "
            f"{summary['flops'] - kernel_flops:.4e} in aten ops; the profiler's "
            f"FLOPs of aten ops {prof_flops:.4e}), {summary['bytes']:.4e} bytes "
            + (f"(the profiler's {prof_ms:.3f} ms of device time could move "
               f"{prof_ms * 1e-3 * HBM_BYTES_PER_S:.4e} at the HBM rate)" if prof_ms
               else "(the profiler recorded no device time: not measured)")
            + f"; launches {launches}")
        del cell
        free_card()
    return rows


def run_sharded_gnn(started=None):
    """Phase 13 -> its fields of the JSON line: the sharded PNA's checks and
    times, the dry run's cells, and the cells counted on the card. The dry
    run (13b) is started here unless `started` (start_dryrun's) gives it:
    `main` starts it before phase 12, whose work is the card's, so that its
    host processes run beside the card's steps."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        started = started or start_dryrun(d)
        try:
            parity = phase_sharded_pna_parity()
            full = phase_sharded_pna_full()
        except BaseException:
            started[0].kill()
            started[0].communicate()
            raise
        dry = finish_dryrun(started)
    counted = phase_cells_on_card()
    log(f"phase 13: {time.perf_counter() - t0:.1f} s ({CARD})")
    return {"sharded_pna": {"parity": parity, "ogb_products": full},
            "dryrun": dry, "cells_on_card": counted}


# ----------------------------------- phase 14: the LM train step on a mesh of ranks
# The reference runs its LM step on a (data, model) device mesh (FSDP on
# data; heads, ff, experts and vocab on model); the port runs it on a mesh
# of torch.distributed ranks (`launch/mesh.py`, `transformer.MeshPlan`).
# One card holds one NCCL rank, so the mesh's four ranks share the card
# over gloo, every rank's tensors and kernels on the card, a collective's
# tensors staged through host memory (`launch/mesh.py`). 14a-14b and 14d
# run in one spawned job of SHARDED_LM_RANKS ranks; 14c in a process of
# its own on a one-rank NCCL group.
SHARDED_LM_MESH = (2, 2)
SHARDED_LM_RANKS = 4
LM_ALL_ARCHS = (LM_ARCH,) + LM_ARCHS
# 14a: 12d's step (f32, the kernel's head dims, 2 microbatches of 2 x 64
# tokens, full remat): each microbatch's rows split one a data rank
SHARDED_LM_STEPS = 3
# 14b: full width in bf16, train_4k cut to 2 x 4,096 tokens as one
# microbatch (a sequence a data rank), full remat, f32 moments, the state
# donated; the depths (deepseek: 1 dense + 2 MoE layers of 64 experts, 32
# a model rank), each reckoned per rank on the meta device. Two steps: the
# first warms up, the second is timed (a step takes 10-17 s on the H100,
# 90-95% of it in the staged collectives: PERF.md §5)
SHARDED_LM_CUT = {"qwen3-8b": 8, "deepseek-v2-lite-16b": 3}
SHARDED_LM_FULL_BATCH = 2
SHARDED_LM_FULL_STEPS = 2
# a rank's CUDA context, beside its reckoned peak (the four must fit the card)
SHARDED_LM_CONTEXT_GIB = 0.6
# 14d: 3 steps at (2, 2), a checkpoint, step 4 restored onto (3, 1): 6 rows
# of 64 tokens a step split over 2 and then 3 data ranks
SHARDED_LM_ELASTIC = ((2, 2), (3, 1), 6, 64)
SHARDED_LM_TIMEOUT_S = 600


def sharded_lm_tc(arch):
    """14a's train config: 12d's."""
    return TrainConfig(optimizer=AdamWConfig(
        state_dtype=cells.LM_STATE_DTYPE.get(arch, "float32"), **TRAIN_OPT),
        warmup_steps=1, total_steps=10, microbatches=LM_ARCH_TRAIN_MICRO, remat=True)


def sharded_lm_full_tc():
    return TrainConfig(optimizer=AdamWConfig(lr=3e-4), microbatches=1, remat=True,
                       warmup_steps=1, total_steps=SHARDED_LM_FULL_STEPS)


def sharded_lm_full(arch):
    """14b's (config, tokens a sequence) for `arch`: full width at its cut."""
    return (dataclasses.replace(get_arch(arch).CONFIG, n_layers=SHARDED_LM_CUT[arch]),
            get_arch(arch).SHAPES[LM_TRAIN_SHAPE].seq_len)


def rank_reckoned_gib(cfg, tc, mesh_shape, batch, seq):
    """One rank's reckoning on the meta device (the dry run's way: shapes,
    no storage): its blocks of the state (`state_shardings` at mesh_shape),
    LM_TRAIN_GRAD_BYTES of gradients a parameter of its blocks (12e's
    rule), and its rows of the batch."""
    from repro_torch import sharding
    from repro_torch.train.step import state_shardings

    model = Transformer(cfg, device="meta")
    sh = state_shardings(model, tc, mesh_shape)
    sizes = dict(zip(mesh_shape.axis_names, mesh_shape.shape))

    def local(shape, spec):
        shape = list(shape)
        for i, ax in enumerate(spec):
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                shape[i] //= sizes[a]
        return int(np.prod(shape))

    specs = leaves(sh["params"], is_leaf=sharding.is_spec_leaf)
    n_local = [local(p.shape, s) for p, s in zip(leaves(param_tree(model)), specs)]
    moment = adamw.STATE_DTYPES[tc.optimizer.state_dtype].itemsize
    elt = transformer.DTYPES[cfg.dtype].itemsize
    rows = batch // sizes.get("data", 1)
    return (sum(n_local) * (elt + 2 * moment + LM_TRAIN_GRAD_BYTES)
            + 2 * rows * seq * 4) / 2**30, sum(n_local)


COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")


def timed_collectives():
    """Wrap launch/mesh's collectives (the model's autograd Functions and
    the step call them by name) so that each one's wall time, from a device
    sync before it to one after it, its input bytes and its calls add up in
    the returned dict, by collective ({name: [seconds, bytes, calls]})."""
    from repro_torch.launch import mesh as rmesh

    spent = {name: [0.0, 0, 0] for name in COLLECTIVES}

    def timing(name, fn):
        def call(x, *a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(x, *a, **k)
            sync()
            rec = spent[name]
            rec[0] += time.perf_counter() - t0
            rec[1] += x.numel() * x.element_size()
            rec[2] += 1
            return out
        return call

    for name in COLLECTIVES:
        setattr(rmesh, name, timing(name, getattr(rmesh, name)))
    return spent


@contextlib.contextmanager
def first_routes(limit):
    """The first `limit` `moe_dispatch` calls while open (a step's forward
    routes its MoE layers in order before remat recomputes them) -> a list
    of {"top": each token's top-k experts, sorted, int16 [T, k]; "gap": its
    k-th minus its (k+1)-th router probability, f32 [T]; "dropped": the
    entries past capacity}, on the host."""
    calls = []
    dispatch = transformer.moe_dispatch

    def recording(x2d, router, cfg, dropless=False):
        out = dispatch(x2d, router, cfg, dropless=dropless)
        if len(calls) < limit:
            with torch.no_grad():
                top = torch.topk(torch.softmax(x2d.float() @ router, dim=-1),
                                 cfg.top_k + 1, dim=-1)
                calls.append({
                    "top": top.indices[:, :-1].sort(-1).values.to(torch.int16).cpu(),
                    "gap": (top.values[:, -2] - top.values[:, -1]).cpu(),
                    "dropped": int((~out[2]).sum())})
        return out

    transformer.moe_dispatch = recording
    try:
        yield calls
    finally:
        transformer.moe_dispatch = dispatch


@contextlib.contextmanager
def first_loss_terms():
    """The CE and the router aux loss of the first `Transformer.loss` call
    while open -> {"ce", "aux"} (on a mesh, this rank's shares: the data
    ranks' sum to the global terms)."""
    terms = {}
    loss = Transformer.loss

    def recording(self, batch, remat=False, plan=None):
        out = loss(self, batch, remat=remat, plan=plan)
        if not terms:
            terms.update(ce=float(out[1]["ce"].detach()), aux=float(out[1]["aux"].detach()))
        return out

    Transformer.loss = recording
    try:
        yield terms
    finally:
        Transformer.loss = loss


def n_moe_layers(cfg):
    return cfg.n_layers - cfg.first_dense_layers if cfg.moe else 0


def sharded_lm_rank(rank, init, out_dir, device, full_shapes):
    """One rank of phase 14's job on `device`: 14a's five archs, 14d's
    elastic restore, 14b's steps of `full_shapes` ({arch: (config, tokens a
    sequence)}); results into out_dir (rank 0's gathered states, every
    rank's report)."""
    from repro_torch.launch import mesh as rmesh
    from repro_torch.sharding import gather_tree
    from repro_torch.train.step import state_shardings

    global DEVICE
    DEVICE = device
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rmesh.make_shard_group(SHARDED_LM_RANKS, backend="gloo", init_method=init,
                           rank=rank, timeout_s=300)
    mesh = rmesh.make_rank_mesh(SHARDED_LM_MESH)
    report = {"rank": rank, "coords": mesh.coords, "14a": {}, "14b": {}}
    # 14a
    for arch in LM_ALL_ARCHS:
        cfg, tc = serve_cli.serve_config(arch), sharded_lm_tc(arch)
        model = Transformer(cfg, device=DEVICE, seed=SEED)
        sh = state_shardings(model, tc, mesh)
        state = init_train_state(model, tc, mesh=mesh)
        step = build_train_step(model, tc, mesh=mesh)
        stream = SyntheticTokenStream(cfg.vocab, *LM_ARCH_TRAIN_TOKENS, seed=SEED,
                                      device=DEVICE)
        registry.reset_launches()
        losses = []
        for i in range(SHARDED_LM_STEPS):
            state, met = step(state, stream(i))
            losses.append(float(met["loss"]))
        report["14a"][arch] = {
            "launches": registry.launch_counts()["flash_attention"],
            "variants": registry.variant_counts("flash_attention"),
            "plain_calls": plain_calls_on_card(), "losses": losses}
        full = gather_tree(state, sh, mesh)
        if rank == 0:
            torch.save({"losses": losses, "params": tree_map(lambda t: t.cpu(), full["params"])},
                       os.path.join(out_dir, f"14a-{arch}.pt"))
        del model, state, step, full
    # 14d
    first, second, rows, seq = SHARDED_LM_ELASTIC
    cfg = serve_cli.serve_config(LM_ARCH)
    model = Transformer(cfg, device=DEVICE, seed=SEED)
    tc = train_tc()
    stream = SyntheticTokenStream(cfg.vocab, rows, seq, seed=SEED, device=DEVICE)
    ckpt_dir = os.path.join(out_dir, "ckpt")
    elastic = {}
    for shape, ranks, steps in ((first, None, SHARDED_LM_STEPS),
                                (second, list(range(int(np.prod(second)))),
                                 SHARDED_LM_STEPS + 1)):
        m = rmesh.make_rank_mesh(shape, ranks=ranks)
        if m is None:
            continue
        sh = state_shardings(model, tc, m)
        rep = trainer.run(init_train_state(model, tc, mesh=m), build_train_step(model, tc, mesh=m),
                          stream, num_steps=steps, ckpt_dir=ckpt_dir,
                          ckpt_interval=SHARDED_LM_STEPS, mesh=m, specs=sh)
        elastic[str(shape)] = {"losses": rep.losses, "steps_run": rep.steps_run,
                               "final_step": rep.final_step}
    report["14d"] = elastic
    del model
    free_card()
    # 14b
    spent = timed_collectives()
    for arch, (cfg, seq) in full_shapes.items():
        tc = sharded_lm_full_tc()
        t0 = time.perf_counter()
        model = Transformer(cfg, device=DEVICE, seed=SEED)
        state = init_train_state(model, tc, mesh=mesh)
        model.to("meta")
        free_card()
        init_s = time.perf_counter() - t0
        step = build_train_step(model, tc, donate=True, mesh=mesh)
        stream = SyntheticTokenStream(cfg.vocab, SHARDED_LM_FULL_BATCH, seq, seed=SEED,
                                      device=DEVICE)
        reset_peak()
        registry.reset_launches()
        times, coll, losses = [], [], []
        for i in range(SHARDED_LM_FULL_STEPS):
            batch = stream(i)
            sync()
            for rec in spent.values():
                rec[:] = [0.0, 0, 0]
            t0 = time.perf_counter()
            if i == 0:   # the warm-up step: its routing and loss terms
                with first_routes(n_moe_layers(cfg)) as routes, first_loss_terms() as terms:
                    state, met = step(state, batch)
            else:
                state, met = step(state, batch)
            losses.append(float(met["loss"]))
            sync()
            times.append(time.perf_counter() - t0)
            coll.append({name: list(rec) for name, rec in spent.items()})
        report["14b"][arch] = {
            "init_s": init_s, "step_s": times, "collective_s": coll, "losses": losses,
            "peak_gib": peak_gib(),
            "reserved_gib": (torch.cuda.max_memory_reserved() / 2**30
                             if DEVICE == "cuda" else 0.0),
            "launches": registry.launch_counts()["flash_attention"],
            "recomputed": registry.backward_launch_counts()["flash_attention"],
            "variants": registry.variant_counts("flash_attention"),
            "plain_calls": plain_calls_on_card(), "first_terms": terms,
            "dropped": [r["dropped"] for r in routes]}
        if rank == 0 and routes:
            torch.save(routes, os.path.join(out_dir, f"14b-routes-{arch}.pt"))
        del model, state, step, stream
        free_card()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def sharded_lm_references(full_shapes):
    """The parent's single-process steps on the card, before the ranks
    start: 14a's three steps of each arch, 14d's uninterrupted four, and
    14b's first loss of the bf16 model at each cut (its forward alone, on
    the whole batch as the step takes it: the loss, its CE and aux terms and
    the routing), with the mean of the sequences' losses each taken alone
    beside it (the MoE layers then route 4,096 tokens at a time)."""
    refs = {"14a": {}, "14b": {}}
    for arch in LM_ALL_ARCHS:
        cfg, tc = serve_cli.serve_config(arch), sharded_lm_tc(arch)
        model = Transformer(cfg, device=DEVICE, seed=SEED)
        state, step = init_train_state(model, tc), build_train_step(model, tc)
        stream = SyntheticTokenStream(cfg.vocab, *LM_ARCH_TRAIN_TOKENS, seed=SEED,
                                      device=DEVICE)
        losses = []
        for i in range(SHARDED_LM_STEPS):
            state, met = step(state, stream(i))
            losses.append(float(met["loss"]))
        refs["14a"][arch] = {"losses": losses, "params": state["params"]}
    _, _, rows, seq = SHARDED_LM_ELASTIC
    cfg = serve_cli.serve_config(LM_ARCH)
    model, tc = Transformer(cfg, device=DEVICE, seed=SEED), train_tc()
    state, step = init_train_state(model, tc), build_train_step(model, tc)
    stream = SyntheticTokenStream(cfg.vocab, rows, seq, seed=SEED, device=DEVICE)
    losses = []
    for i in range(SHARDED_LM_STEPS + 1):
        state, met = step(state, stream(i))
        losses.append(float(met["loss"]))
    refs["14d"] = {"losses": losses, "state": state}
    for arch, (cfg, seq) in full_shapes.items():
        model = Transformer(cfg, device=DEVICE, seed=SEED)
        batch = SyntheticTokenStream(cfg.vocab, SHARDED_LM_FULL_BATCH, seq, seed=SEED,
                                     device=DEVICE)(0)
        with torch.no_grad():
            with first_routes(n_moe_layers(cfg)) as routes:
                loss, terms = model.loss(batch)
            per_sequence = float(torch.stack([   # equal counts: the mean of the means
                model.loss({k: v[i:i + 1] for k, v in batch.items()})[0]
                for i in range(SHARDED_LM_FULL_BATCH)]).mean())
        refs["14b"][arch] = {"loss": float(loss), "ce": float(terms["ce"]),
                             "aux": float(terms["aux"]), "per_sequence": per_sequence,
                             "routes": routes}
        del model
        free_card()
    return refs


def sharded_lm_nccl_worker():
    """14c, in a process of its own (deterministic algorithms, cuBLAS's
    workspace set before the first product): each arch's 14a step on a
    (1, 1) mesh over a one-rank NCCL group against the single-process step,
    bit for bit; prints a JSON line and "OK"."""
    from repro_torch.launch import mesh as rmesh
    from repro_torch.optim.tree import keyed_leaves

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as d:
        rmesh.make_shard_group(1, backend="nccl", rank=0,
                               init_method=f"file://{d}/rendezvous")
        one = rmesh.make_rank_mesh((1, 1))
        out = {}
        for arch in LM_ALL_ARCHS:
            cfg, tc = serve_cli.serve_config(arch), sharded_lm_tc(arch)
            model = Transformer(cfg, device=DEVICE, seed=SEED)
            runs = []
            for m in (None, one):
                state = init_train_state(model, tc, mesh=m)
                step = build_train_step(model, tc, mesh=m)
                stream = SyntheticTokenStream(cfg.vocab, *LM_ARCH_TRAIN_TOKENS, seed=SEED,
                                              device=DEVICE)
                losses = []
                for i in range(SHARDED_LM_STEPS):
                    state, met = step(state, stream(i))
                    losses.append(float(met["loss"]))
                runs.append((losses, state))
            (l0, s0), (l1, s1) = runs
            same = l0 == l1 and all(torch.equal(a, b) for (_, a), (_, b) in zip(
                keyed_leaves(s0), keyed_leaves(s1)))
            out[arch] = {"losses": l1, "bit_equal": same}
            check(same, f"14c {arch}: the (1, 1) NCCL mesh's step differs from the "
                  f"single-process step: losses {l1} vs {l0}")
        import torch.distributed as dist
        dist.destroy_process_group()
    print(json.dumps(out))
    print("OK")


def run_sharded_lm():
    """Phase 14 -> its fields of the flash_attention entry of the JSON line:
    the launches per rank on the mesh (14a, 14b), 14b's times and peaks."""
    import torch.multiprocessing as mp
    from repro_torch.sharding import MeshShape

    t_phase = time.perf_counter()
    mesh_shape = MeshShape(("data", "model"), SHARDED_LM_MESH)
    log(f"== phase 14: the LM train step on a {SHARDED_LM_MESH} (data, model) mesh of "
        f"{SHARDED_LM_RANKS} gloo ranks sharing the card ({CARD})")
    free_card()
    reckoned = {}
    full_shapes = {arch: sharded_lm_full(arch) for arch in SHARDED_LM_CUT}
    for arch, (cfg, seq) in full_shapes.items():
        gib, n_local = rank_reckoned_gib(cfg, sharded_lm_full_tc(), mesh_shape,
                                         SHARDED_LM_FULL_BATCH, seq)
        total = SHARDED_LM_RANKS * (gib + SHARDED_LM_CONTEXT_GIB)
        reckoned[arch] = gib
        log(f"14b {arch} cut to {cfg.n_layers} of {get_arch(arch).CONFIG.n_layers} "
            f"layers ({cfg.n_params()} parameters, {n_local} a rank): reckoned {gib:.3f} "
            f"GiB a rank on the meta device (its blocks of the bf16 parameters and f32 "
            f"moments, {LM_TRAIN_GRAD_BYTES} bytes a parameter of gradients, its rows); "
            f"{SHARDED_LM_RANKS} x ({gib:.2f} + {SHARDED_LM_CONTEXT_GIB} context) = "
            f"{total:.1f} GiB")
        check(total <= LM_TRAIN_BUDGET * 80,
              f"14b {arch}: the ranks reckon at {total:.1f} GiB, over "
              f"{LM_TRAIN_BUDGET:.0%} of 80 GiB")
    # the ranks start first: the parent's single-process references and 14c
    # (a process of its own, on one NCCL rank) run while the ranks take 14a
    # and 14d, all small, and are done before the ranks reach 14b
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUBLAS_WORKSPACE_CONFIG=":4096:8")
    code = f"import chip_smoke as cs; cs.DEVICE = {DEVICE!r}; cs.sharded_lm_nccl_worker()"
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ctx = mp.start_processes(sharded_lm_rank,
                                 args=(f"file://{d}/rendezvous", d, DEVICE, full_shapes),
                                 nprocs=SHARDED_LM_RANKS, join=False, start_method="spawn")
        nccl = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        end = time.monotonic() + SHARDED_LM_TIMEOUT_S
        try:
            t1 = time.perf_counter()
            refs = sharded_lm_references(full_shapes)
            free_card()
            log(f"single-process references on the card: {time.perf_counter() - t1:.1f} s "
                "(beside the ranks' 14a)")
            out14c, err14c = nccl.communicate(timeout=SHARDED_LM_TIMEOUT_S)
            s14c = time.perf_counter() - t0
            while not ctx.join(timeout=1):
                check(time.monotonic() < end,
                      f"phase 14's ranks not done within {SHARDED_LM_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join(10)
            if nccl.poll() is None:
                nccl.kill()
                nccl.communicate()
        job_s = time.perf_counter() - t0
        reports = []
        for r in range(SHARDED_LM_RANKS):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        got = {arch: torch.load(os.path.join(d, f"14a-{arch}.pt")) for arch in LM_ALL_ARCHS}
        mesh_routes = {arch: torch.load(os.path.join(d, f"14b-routes-{arch}.pt"))
                       for arch, (cfg, _) in full_shapes.items() if cfg.moe}
        from repro_torch.checkpoint import ckpt

        resumed, meta = ckpt.restore_checkpoint(os.path.join(d, "ckpt"), refs["14d"]["state"],
                                                step=SHARDED_LM_STEPS + 1, device="cpu")
    log(f"the ranks' job: {job_s:.1f} s (spawn, 14a, 14d, 14b)")
    # 14a
    log(f"== phase 14a: the five archs' smoke step (12d's: f32, the kernel's head dims, "
        f"{LM_ARCH_TRAIN_MICRO} microbatches of {LM_ARCH_TRAIN_TOKENS[0] // LM_ARCH_TRAIN_MICRO}"
        f" x {LM_ARCH_TRAIN_TOKENS[1]} tokens, one row a data rank, remat) at "
        f"{SHARDED_LM_MESH}, {SHARDED_LM_STEPS} steps against the single-process step on "
        f"the card (losses rtol {TRAIN_LOSS_TOL}, parameters atol {TRAIN_PARAM_TOL} but "
        f"for {TRAIN_FLIP_SHARE} of a leaf)")
    launches_a = {}
    for arch in LM_ALL_ARCHS:
        cfg = serve_cli.serve_config(arch)
        ref = refs["14a"][arch]
        check(np.allclose(got[arch]["losses"], ref["losses"], rtol=TRAIN_LOSS_TOL, atol=0),
              f"14a {arch}: losses {got[arch]['losses']} vs {ref['losses']}")
        diff, flips, top = params_diff(got[arch]["params"], ref["params"],
                                       SHARDED_LM_STEPS, TRAIN_OPT["lr"])
        want = SHARDED_LM_STEPS * LM_ARCH_TRAIN_MICRO * (2 * cfg.n_layers + int(cfg.mtp))
        per_rank = [r["14a"][arch]["launches"] for r in reports]
        for r in reports:
            a = r["14a"][arch]
            check(a["launches"] == want and a["variants"].get("f32", 0) == want
                  and not a["plain_calls"],
                  f"14a {arch} rank {r['rank']}: flash_attention {a['launches']} launches "
                  f"by variant {a['variants']}, plain calls {a['plain_calls']}; "
                  f"expected {want}, all f32")
            check(a["losses"] == got[arch]["losses"],
                  f"14a {arch}: rank {r['rank']}'s losses differ from rank 0's")
        launches_a[arch] = per_rank
        log(f"  {arch}: losses {[round(x, 6) for x in got[arch]['losses']]} (single "
            f"process {[round(x, 6) for x in ref['losses']]}), parameters max |mesh - "
            f"single| {diff:.3g}{f' ({flips} entries by up to {top:.3g})' if flips else ''};"
            f" flash_attention launches per rank {per_rank} (f32 kernel, each rank's "
            f"local heads; {want} expected)")
    # 14d
    first, second, rows, seq = SHARDED_LM_ELASTIC
    ref = refs["14d"]
    e0 = reports[0]["14d"]
    check(e0[str(first)]["steps_run"] == SHARDED_LM_STEPS
          and e0[str(second)]["final_step"] == SHARDED_LM_STEPS + 1
          and e0[str(second)]["steps_run"] == 1 and int(meta["step"]) == SHARDED_LM_STEPS + 1,
          f"14d: runs {e0}")
    check(np.allclose(e0[str(first)]["losses"] + e0[str(second)]["losses"], ref["losses"],
                      rtol=TRAIN_LOSS_TOL, atol=0),
          f"14d: losses {e0} vs the uninterrupted {ref['losses']}")
    diff, flips, top = params_diff(tree_map(torch.as_tensor, resumed["params"]),
                                   ref["state"]["params"], SHARDED_LM_STEPS + 1,
                                   TRAIN_OPT["lr"])
    log(f"== phase 14d: {LM_ARCH} smoke (f32, {rows} x {seq} tokens a step): "
        f"{SHARDED_LM_STEPS} steps at {first}, the checkpoint (gathered, rank 0 "
        f"writing) restored onto {second}, step {SHARDED_LM_STEPS + 1} there: losses "
        f"{[round(x, 6) for x in e0[str(first)]['losses'] + e0[str(second)]['losses']]}, "
        f"the uninterrupted single-process run {[round(x, 6) for x in ref['losses']]}; "
        f"parameters at step {SHARDED_LM_STEPS + 1} max |restored - uninterrupted| "
        f"{diff:.3g}{f' ({flips} entries by up to {top:.3g})' if flips else ''}")
    # 14b
    full = {}
    for arch, (cfg, seq) in full_shapes.items():
        rs = [r["14b"][arch] for r in reports]
        step_s = [float(np.median(r["step_s"][1:])) for r in rs]   # after the warm-up
        coll_share = [float(sum(c[n][0] for c in r["collective_s"][1:] for n in c)
                            / np.sum(r["step_s"][1:])) for r in rs]
        # rank 0's last step, by collective: [seconds, bytes in, calls]
        by_kind = rs[0]["collective_s"][-1]
        tokens = SHARDED_LM_FULL_BATCH * seq
        ref = refs["14b"][arch]
        first_rel = abs(rs[0]["losses"][0] - ref["loss"]) / abs(ref["loss"])
        per_sequence_rel = abs(ref["per_sequence"] - ref["loss"]) / abs(ref["loss"])
        # the mesh's terms: the shares of one rank of each data row summed
        terms = {t: sum(r["14b"][arch]["first_terms"][t] for r in reports
                        if r["coords"]["model"] == 0) for t in ("ce", "aux")}
        routing = []
        for mine, theirs in zip(mesh_routes.get(arch, []), ref["routes"]):
            differ = (mine["top"] != theirs["top"]).any(-1)
            routing.append({
                "tokens": int(differ.numel()), "top_k_differ": int(differ.sum()),
                "max_gap_where_differ": float(theirs["gap"][differ].max()) if differ.any()
                else None,
                "dropped": [mine["dropped"], theirs["dropped"]]})
        want = 2 * cfg.n_layers * SHARDED_LM_FULL_STEPS
        for r in rs:
            check(all(np.isfinite(r["losses"])), f"14b {arch}: losses {r['losses']}")
            check(r["launches"] == want and r["recomputed"] == want // 2
                  and r["variants"].get("bf16_tc", 0) == want and not r["plain_calls"],
                  f"14b {arch}: flash_attention {r['launches']} launches ({r['recomputed']} "
                  f"in the backward) by variant {r['variants']}, plain calls "
                  f"{r['plain_calls']}; expected {want}, all bf16_tc")
        check(first_rel <= LM_PARITY_TOL,
              f"14b {arch}: the first loss {rs[0]['losses'][0]:.6f} is {first_rel:.3g} from "
              f"the single-process bf16 loss {ref['loss']:.6f}, over {LM_PARITY_TOL}")
        s = max(step_s)
        full[arch] = {
            "n_layers": cfg.n_layers, "n_params": cfg.n_params(), "mesh": SHARDED_LM_MESH,
            "step_s": s, "tokens_per_s": tokens / s, "losses": rs[0]["losses"],
            "first_loss_rel": first_rel, "first_terms": {"mesh": terms, "single": {
                t: ref[t] for t in ("ce", "aux")}},
            "per_sequence_loss_rel": per_sequence_rel, "routing": routing,
            "reckoned_gib": reckoned[arch],
            "peak_gib": [r["peak_gib"] for r in rs],
            "reserved_gib": [r["reserved_gib"] for r in rs],
            "collective_share": coll_share, "collectives_last_step_rank0": by_kind,
            "init_s": [r["init_s"] for r in rs],
            "launches_per_step": rs[0]["launches"] / SHARDED_LM_FULL_STEPS}
        log(f"== phase 14b: {cfg.name} at full width in bf16, cut to {cfg.n_layers} of "
            f"{get_arch(arch).CONFIG.n_layers} layers"
            f"{f' ({cfg.first_dense_layers} dense + {cfg.n_layers - cfg.first_dense_layers} MoE of {cfg.n_routed} experts, {cfg.n_routed // SHARDED_LM_MESH[1]} a model rank)' if cfg.moe else ''}"
            f", {SHARDED_LM_FULL_BATCH} x {seq} tokens a step as one microbatch (one "
            f"sequence a data rank, the heads, ff, experts and vocabulary split over the "
            f"model ranks), remat, f32 moments, the state donated, {SHARDED_LM_MESH} "
            f"({CARD})")
        log(f"  seconds a step (step{'s' if SHARDED_LM_FULL_STEPS > 2 else ''} "
            f"1{f'-{SHARDED_LM_FULL_STEPS - 1}, median' if SHARDED_LM_FULL_STEPS > 2 else ''}"
            f", the slowest rank) {s:.3f}, {tokens / s:.0f} tokens/s; per rank {[round(x, 3) for x in step_s]} s, "
            f"collectives {[f'{100 * c:.1f}%' for c in coll_share]} of the step (gloo, "
            f"staged through page-locked host memory; rank 0's last step by collective: "
            + ", ".join(f"{n} {v[0]:.2f} s for {v[1] / 2**30:.2f} GiB in {v[2]} calls"
                        for n, v in by_kind.items())
            + f"); losses {[round(x, 6) for x in rs[0]['losses']]}, "
            f"the first {first_rel:.3g} from the single-process bf16 loss "
            f"{ref['loss']:.6f} of the whole batch (CE {terms['ce']:.6f} on the mesh, "
            f"{ref['ce']:.6f} single; aux {terms['aux']:.6f} and {ref['aux']:.6f}; the "
            f"sequences' losses taken alone average {ref['per_sequence']:.6f}, "
            f"{per_sequence_rel:.3g} from it); peak per rank {[round(r['peak_gib'], 3) for r in rs]} "
            f"GiB (reserved {[round(r['reserved_gib'], 3) for r in rs]}) against "
            f"{reckoned[arch]:.3f} reckoned; the weights made and sharded in "
            f"{max(r['init_s'] for r in rs):.1f} s; flash_attention "
            f"{rs[0]['launches'] // SHARDED_LM_FULL_STEPS} launches a step a rank "
            f"({cfg.n_layers} layers, forward and remat's recompute), all bf16_tc")
        for j, r in enumerate(routing):
            log(f"  MoE layer {j + 1} at the first step, mesh (rank 0) vs single process: "
                f"{r['top_k_differ']} of {r['tokens']} tokens with another top-{cfg.top_k} "
                f"set (the largest k-th to (k+1)-th router probability gap among them "
                f"{r['max_gap_where_differ']}); entries dropped past capacity "
                f"{r['dropped'][0]} and {r['dropped'][1]}")
    # 14c
    log("== phase 14c: the 14a step on a (1, 1) mesh over a one-rank NCCL group, "
        "against the single-process step, bit for bit (deterministic algorithms)")
    log(out14c.strip())
    check(nccl.returncode == 0 and out14c.strip().endswith("OK"),
          f"14c failed ({nccl.returncode}): {err14c[-3000:]}")
    log(f"14c: every arch bit for bit (in its own process beside the ranks, done {s14c:.1f} s "
        "after they started)")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s ({CARD})")
    return {"launches_sharded_train": {
        "14a": launches_a,
        "14b": {a: [r["14b"][a]["launches"] / SHARDED_LM_FULL_STEPS for r in reports]
                for a in SHARDED_LM_CUT}},
        "sharded_train": full}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    # f32 products in full f32 on the card, as on the CPU (PyTorch's
    # defaults, stated): TF32 would move the GNN logits past LOGIT_TOL
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kind = phase_device()
    kernels, seconds = [], {}
    for run in (run_prune, run_gnn, run_lm, run_recsys):
        t0 = time.perf_counter()
        kernels += run()
        seconds[run.__name__] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    train = run_train(with_gnn=False)
    seconds["run_train"] = round(time.perf_counter() - t0, 1)
    with tempfile.TemporaryDirectory() as d:
        dry = start_dryrun(d)
        try:
            t0 = time.perf_counter()
            archs = run_lm_archs()
            seconds["run_lm_archs"] = round(time.perf_counter() - t0, 1)
        except BaseException:
            dry[0].kill()
            dry[0].communicate()
            raise
        t0 = time.perf_counter()
        sharded = run_sharded_gnn(dry)
        seconds["run_sharded_gnn"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    sharded_lm = run_sharded_lm()
    seconds["run_sharded_lm"] = round(time.perf_counter() - t0, 1)
    for k in kernels:
        k.update(train.get(k["name"], {}))
        if k["name"] == "flash_attention":
            k.update(archs, **sharded_lm)
        if k["name"] == "segment_agg":
            k.update(sharded_pna=sharded["sharded_pna"], dryrun=sharded["dryrun"])
        k["counted_on_card"] = [r for r in sharded["cells_on_card"]
                                if k["name"] in r["launches"]]
    log(f"total {time.perf_counter() - t_start:.1f} s (by path: {seconds})")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
