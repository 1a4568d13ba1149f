"""Static edge partition with all-to-all buckets, for the sharded backends.

The JAX package's partition (the adaptation of HavoqGT's delegate-partitioned
message queues to static shapes), built the same way on the host with numpy:

- vertices are block-partitioned over P shards (shard = v // n_local),
- every arc (u -> v) lives on shard(u) (the "push" layout),
- per shard, arcs are grouped into P buckets by shard(v), padded to one
  bucket size B, so one all-to-all per sweep exchanges exactly the per-arc
  payloads (omega words, frontier words) of cut and local arcs,
- the receiving shard ORs what it received into its vertices along a static
  dst-sorted arc list (`recv_arcs`), which `bitset_spmm` walks on the card.

A hub's arcs spread over the source shards of its neighbours, so no shard
carries a hub's whole traffic. Arcs are laid out in the reference's
deterministic order, so every array equals the JAX package's field for
field. `device_arrays(device)` uploads the static index arrays once per
partition and device, as int32 (no per-sweep int64 copy). `partition_shapes`
gives the same shapes analytically, with no allocation.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.structs import Graph


def _ceil_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# the static arrays a shard program reads, all [P, ...] with the shard first
SHARD_FIELDS = ("send_src_local", "send_pad", "twin_recv_flat", "recv_perm",
                "recv_sorted_dst_local", "labels_local", "vertex_valid")


@dataclasses.dataclass
class EdgePartition:
    """Static partition arrays; the leading axis P is the shard axis."""

    P: int
    n: int
    n_local: int  # vertices per shard (padded block)
    B: int  # bucket size (arcs per (src_shard, dst_shard) bucket, padded)

    # send layout [P, P, B]: bucket (p, q) holds arcs from shard p to shard q
    send_src_local: np.ndarray  # int32, gather index into local omega (n_local = pad row)
    send_pad: np.ndarray  # bool, True for padding slots
    twin_recv_flat: np.ndarray  # int32, flat index of the twin arc's message in OUR recv buffer

    # receive layout [P, P*B] (flattened (src_shard, slot)); static dst-sorted metadata
    recv_perm: np.ndarray  # int32[P, P*B] sorts received messages by local dst
    recv_sorted_dst_local: np.ndarray  # int32[P, P*B] (n_local for pads)
    recv_is_start: np.ndarray  # bool[P, P*B]
    recv_last_edge: np.ndarray  # int32[P, n_local], -1 if vertex has no in-arc

    labels_local: np.ndarray  # int32[P, n_local]
    vertex_valid: np.ndarray  # bool[P, n_local]

    # bookkeeping for mapping answers back
    global_of_local: np.ndarray  # int32[P, n_local] global vertex id (or -1)

    # per-arc slot in the flattened [P, P, B] bucket tensor, in the host
    # Graph's arc order: the backends' edge_active gather/scatter map
    arc_flat_slot: Optional[np.ndarray] = None  # int64[m]

    # destination local index per send bucket slot (n_local for pads); the
    # sharded enumeration join reads arc destinations from it
    send_dst_local: Optional[np.ndarray] = None  # int32[P, P, B]

    def __post_init__(self):
        self._join_plan: Optional["JoinPlan"] = None
        self._row_plan: Optional["RowPlan"] = None
        self._dev: Dict = {}
        self._join_plan_dev: Dict = {}
        # the graph this partition was built from and its arcs' (dst, src)
        # order, which `dst_order` hands to the backends
        self._graph = None
        self._by_dst: Optional[np.ndarray] = None

    def dst_order(self, g: Graph) -> np.ndarray:
        """`DeviceGraph.dst_sort_order(g)`: the build's own sort when this
        partition was built from `g`, else a new one."""
        if self._graph is not None and self._graph() is g:
            return self._by_dst
        from repro_torch.graph.structs import DeviceGraph

        return DeviceGraph.dst_sort_order(g)

    @property
    def total_slots(self) -> int:
        return self.P * self.B

    def meta(self) -> Dict[str, int]:
        """JSON-serializable partition facts (shard count and block
        geometry)."""
        return {"P": int(self.P), "n": int(self.n),
                "n_local": int(self.n_local), "B": int(self.B)}

    def join_plan(self) -> "JoinPlan":
        """The (cached) shard-local arc plan the sharded enumeration join
        expands over; see `build_join_plan`."""
        if self._join_plan is None:
            self._join_plan = build_join_plan(self)
        return self._join_plan

    def join_plan_dev(self, device) -> Dict[str, torch.Tensor]:
        """The join plan's static arrays on `device`, uploaded once per
        partition and device: repeated enumerations reuse these buffers.
        Indices are int64 (the join indexes with them), the plan itself
        stays int32 on the host."""
        key = str(torch.device(device))
        if key not in self._join_plan_dev:
            plan = self.join_plan()
            self._join_plan_dev[key] = {
                name: torch.from_numpy(
                    getattr(plan, name).astype(np.int64)).to(device)
                for name in ("perm", "csr_off", "arc_dst", "deg")}
        return self._join_plan_dev[key]

    def row_plan(self) -> "RowPlan":
        """The (cached) row-ownership plan of the distributed-rows join; see
        `build_row_plan`."""
        if self._row_plan is None:
            self._row_plan = build_row_plan(self)
        return self._row_plan

    def recv_arcs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every shard's receive side as one dst-sorted arc list over all P
        shards: (src int32[M], dst int32[M], dst_ptr int64[P*n_local + 1]).
        Arc k takes row src[k] = p*P*B + recv_perm[p, i] of the stacked
        receive buffers [P*P*B, W] to out row dst[k] = p*n_local + v; pad
        slots are left out. Shard p's arcs are the contiguous run
        dst_ptr[p*n_local] .. dst_ptr[(p+1)*n_local]."""
        P, n_local, S = self.P, self.n_local, self.P * self.B
        real = self.recv_sorted_dst_local < n_local
        p_of = np.broadcast_to(np.arange(P, dtype=np.int64)[:, None], real.shape)
        src = (p_of * S + self.recv_perm)[real]
        dst = (p_of * n_local + self.recv_sorted_dst_local)[real]
        ptr = np.zeros(P * n_local + 1, dtype=np.int64)
        ptr[1:] = np.cumsum(np.bincount(dst, minlength=P * n_local))
        return src.astype(np.int32), dst.astype(np.int32), ptr

    def device_arrays(self, device) -> Dict[str, torch.Tensor]:
        """The static arrays of the shard programs on `device`, uploaded once
        per partition and device: SHARD_FIELDS [P, ...] as int32 (bools as
        bool), and the receive arc list of `recv_arcs` (`rx_src`, `rx_dst`
        int32, `rx_ptr` int64) for `bitset_spmm`."""
        key = str(torch.device(device))
        if key not in self._dev:
            d = {name: torch.from_numpy(np.ascontiguousarray(
                     getattr(self, name))).to(device)
                 for name in SHARD_FIELDS}
            src, dst, ptr = self.recv_arcs()
            d["rx_src"] = torch.from_numpy(src).to(device)
            d["rx_dst"] = torch.from_numpy(dst).to(device)
            d["rx_ptr"] = torch.from_numpy(ptr).to(device)
            self._dev[key] = d
        return self._dev[key]


def partition_graph(g: Graph, P: int, pad_multiple: int = 8) -> EdgePartition:
    n_local = (g.n + P - 1) // P
    src_shard = (g.src // n_local).astype(np.int64)
    dst_shard = (g.dst // n_local).astype(np.int64)
    src_lo, dst_lo = g.src % n_local, g.dst % n_local

    # bucket sizes -> uniform B
    counts = np.bincount(src_shard * P + dst_shard, minlength=P * P
                         ).reshape(P, P)
    B = max(int(counts.max()), 1)
    B = _ceil_to(B, pad_multiple)

    send_src_local = np.full((P, P, B), n_local, dtype=np.int32)
    send_dst_local = np.full((P, P, B), n_local, dtype=np.int32)
    send_pad = np.ones((P, P, B), dtype=bool)

    # deterministic order: arcs by (src_shard, dst_shard, dst_local,
    # src_local), the reference's four-key lexsort: the arcs by (dst, src)
    # (= (dst_shard, dst_local, src_shard, src_local)), then a stable sort
    # by bucket, a radix sort on small keys
    by_dst = np.argsort(g.dst.astype(np.int64) * g.n + g.src, kind="stable")
    bucket_of = (src_shard * P + dst_shard)[by_dst]
    if P * P <= np.iinfo(np.int16).max:
        bucket_of = bucket_of.astype(np.int16)
    order = by_dst[np.argsort(bucket_of, kind="stable")]
    s_sh, d_sh = src_shard[order], dst_shard[order]
    s_lo, d_lo = src_lo[order], dst_lo[order]
    # position within bucket
    bucket_key = s_sh * P + d_sh
    new_bucket = np.ones(g.m, dtype=bool)
    new_bucket[1:] = bucket_key[1:] != bucket_key[:-1]
    bucket_start = np.maximum.accumulate(np.where(new_bucket, np.arange(g.m), 0))
    pos = np.arange(g.m) - bucket_start
    send_src_local[s_sh, d_sh, pos] = s_lo
    send_dst_local[s_sh, d_sh, pos] = d_lo
    send_pad[s_sh, d_sh, pos] = False
    slot_of_arc = np.empty(g.m, dtype=np.int64)
    slot_of_arc[order] = pos
    arc_flat_slot = np.empty(g.m, dtype=np.int64)
    arc_flat_slot[order] = (s_sh * P + d_sh) * B + pos

    # twin lookup: arc i=(u,v); twin=(v,u) lives at (dst_sh[i], src_sh[i], slot_of_twin).
    # The receiving shard for arc i's dst-side omega is shard(u)=src_sh[i]; in its recv
    # buffer, source-shard axis = shard(v)=dst_sh[i], slot = twin's slot.
    twin_idx = _twin_index(g, by_dst)
    twin_recv_flat = np.full((P, P, B), P * B, dtype=np.int32)  # pad -> sink slot
    tslot = slot_of_arc[twin_idx]
    twin_recv_flat[s_sh, d_sh, pos] = (d_sh * B + tslot[order]).astype(np.int32)

    # receive metadata per shard p: messages arrive as [P(src_shard q), B];
    # message (q, b) is the arc in bucket (q, p, b). Sorted stably by local
    # dst, shard p's real messages are its in-arcs in (dst, src) order (a
    # bucket holds its arcs by (dst_local, src_local)), then its pad slots
    # in slot order.
    recv_perm = np.empty((P, P * B), dtype=np.int32)
    recv_sorted = np.full((P, P * B), n_local, dtype=np.int32)
    arc_recv = (src_shard * B + slot_of_arc)[by_dst]
    arc_dst_sh, arc_dst_lo = dst_shard[by_dst], dst_lo[by_dst]
    bounds = np.searchsorted(arc_dst_sh, np.arange(P + 1))
    for p in range(P):
        lo, hi = bounds[p], bounds[p + 1]
        recv_perm[p, :hi - lo] = arc_recv[lo:hi]
        recv_sorted[p, :hi - lo] = arc_dst_lo[lo:hi]
        recv_perm[p, hi - lo:] = np.flatnonzero(send_pad[:, p, :].reshape(-1))
    recv_is_start = np.ones((P, P * B), dtype=bool)
    recv_is_start[:, 1:] = recv_sorted[:, 1:] != recv_sorted[:, :-1]
    recv_last_edge = np.full((P, n_local), -1, dtype=np.int32)
    for p in range(P):
        valid = recv_sorted[p] < n_local
        recv_last_edge[p, recv_sorted[p, valid]] = np.arange(P * B, dtype=np.int32)[valid]

    labels_local = np.zeros((P, n_local), dtype=np.int32)
    vertex_valid = np.zeros((P, n_local), dtype=bool)
    global_of_local = np.full((P, n_local), -1, dtype=np.int32)
    ids = np.arange(g.n)
    labels_local[ids // n_local, ids % n_local] = g.labels
    vertex_valid[ids // n_local, ids % n_local] = True
    global_of_local[ids // n_local, ids % n_local] = ids

    part = EdgePartition(
        P=P, n=g.n, n_local=n_local, B=B,
        send_src_local=send_src_local, send_pad=send_pad,
        twin_recv_flat=twin_recv_flat,
        recv_perm=recv_perm, recv_sorted_dst_local=recv_sorted,
        recv_is_start=recv_is_start, recv_last_edge=recv_last_edge,
        labels_local=labels_local, vertex_valid=vertex_valid,
        global_of_local=global_of_local,
        arc_flat_slot=arc_flat_slot,
        send_dst_local=send_dst_local,
    )
    part._graph, part._by_dst = weakref.ref(g), by_dst
    return part


@dataclasses.dataclass
class JoinPlan:
    """Static per-shard arc plan of the sharded enumeration join: every
    shard's arcs re-sorted by (src_local, dst_global), so row expansion is a
    shard-local CSR walk in the same order as the single-device join's
    (src, dst) sort: all arcs of a vertex live on its owner shard.

    `deg` is the static per-vertex out-degree in the padded global id space
    (sink row n_pad has degree 0): the join sizes its expansion slots from
    it, so capacity never depends on the pruned state."""

    A: int  # arcs per shard (P*B, padded)
    n_pad: int  # padded global vertex space (P * n_local)
    perm: np.ndarray  # int32[P, A]: sorted order -> flat bucket slot (gather map)
    csr_off: np.ndarray  # int32[P, n_local + 1] CSR over sorted non-pad arcs
    arc_dst: np.ndarray  # int32[P, A] dst global id in sorted order (n_pad for pads)
    deg: np.ndarray  # int32[n_pad + 1]


def build_join_plan(part: EdgePartition) -> JoinPlan:
    if part.send_dst_local is None or part.arc_flat_slot is None:
        raise ValueError(
            "EdgePartition lacks send_dst_local or arc_flat_slot; rebuild "
            "the partition")
    P, B, n_local = part.P, part.B, part.n_local
    A = P * B
    n_pad = P * n_local
    pad = part.send_pad.reshape(P, A)
    # the arcs by (src, dst) are shard by shard (a shard owns a block of
    # sources) by (src_local, dst_global): one stable sort of the real
    # slots, nearly linear where the host arcs come (src, dst)-sorted, as
    # the generators leave them; each shard's pads follow in slot order,
    # where the stable two-key sort of all its slots puts them
    slots = part.arc_flat_slot
    p_of, rest = slots // A, slots % A
    src_lo = part.send_src_local.reshape(P, A)[p_of, rest].astype(np.int64)
    dst_glob = ((rest // B) * n_local
                + part.send_dst_local.reshape(P, A)[p_of, rest])
    o = np.argsort((p_of * n_local + src_lo) * (n_pad + 1) + dst_glob,
                   kind="stable")
    p_sorted, rest_sorted, dst_sorted = p_of[o], rest[o], dst_glob[o]
    bounds = np.searchsorted(p_sorted, np.arange(P + 1))
    perm = np.empty((P, A), dtype=np.int32)
    csr_off = np.zeros((P, n_local + 1), dtype=np.int64)
    arc_dst = np.full((P, A), n_pad, dtype=np.int32)
    deg = np.zeros(n_pad + 1, dtype=np.int64)
    for p in range(P):
        lo, hi = bounds[p], bounds[p + 1]
        perm[p, :hi - lo] = rest_sorted[lo:hi]
        perm[p, hi - lo:] = np.flatnonzero(pad[p])
        arc_dst[p, :hi - lo] = dst_sorted[lo:hi]
        counts = np.bincount(src_lo[o[lo:hi]], minlength=n_local)
        csr_off[p, 1:] = np.cumsum(counts)
        deg[p * n_local : p * n_local + n_local] = counts
    return JoinPlan(A=A, n_pad=n_pad, perm=perm,
                    csr_off=csr_off.astype(np.int32), arc_dst=arc_dst,
                    deg=deg.astype(np.int32))


@dataclasses.dataclass
class RowPlan:
    """Row-ownership plan of the distributed-rows join (core/join.py).

    A partial-embedding row lives on the shard that owns the row's next
    frontier vertex, owner(v) = v // n_local (the partition's block rule):
    that shard holds every arc of v in its join-plan CSR, so expansion is
    local once rows are routed. Only row placement varies with P, never row
    content. `deg` is a host int64 copy of the join plan's degree table."""

    P: int
    n_local: int
    n_pad: int
    deg: np.ndarray  # int64[n_pad + 1]

    def owner_of(self, v: np.ndarray) -> np.ndarray:
        """Owner shard per global vertex id; the sink id n_pad maps to P
        (the 'nowhere' bucket pads route around)."""
        return np.minimum(np.asarray(v, np.int64) // self.n_local, self.P)

    def shard_rows(self, rows: np.ndarray, owner_col: int,
                   pow2_pad) -> Tuple[np.ndarray, np.ndarray]:
        """Bucket host rows [K, C] by the owner of column `owner_col` into a
        padded [P, Rb, C] block (sink rows = n_pad) and per-shard counts.
        Order within a shard keeps the input order (stable)."""
        rows = np.asarray(rows, np.int32)
        owner = self.owner_of(rows[:, owner_col])
        counts = np.bincount(owner, minlength=self.P)[: self.P]
        rb = pow2_pad(int(counts.max()) if counts.size else 0)
        out = np.full((self.P, rb, rows.shape[1]), self.n_pad, np.int32)
        for p in range(self.P):
            sel = rows[owner == p]
            out[p, : sel.shape[0]] = sel
        return out, counts.astype(np.int64)


def build_row_plan(part: EdgePartition) -> RowPlan:
    plan = part.join_plan()
    return RowPlan(P=part.P, n_local=part.n_local, n_pad=plan.n_pad,
                   deg=plan.deg.astype(np.int64))


def _twin_index(g: Graph, by_dst: Optional[np.ndarray] = None) -> np.ndarray:
    """For each arc i=(u,v), index j of its twin (v,u). Graph must be
    undirected: then the arcs sorted by (src, dst) and by (dst, src) are
    twins position for position. `by_dst` is the (dst, src) order if the
    caller has it."""
    key = g.src.astype(np.int64) * g.n + g.dst
    tkey = g.dst.astype(np.int64) * g.n + g.src
    if by_dst is None:
        by_dst = np.argsort(tkey, kind="stable")
    twin = np.empty(g.m, dtype=np.int64)
    twin[np.argsort(key, kind="stable")] = by_dst
    if not np.array_equal(key[twin], tkey):
        raise ValueError("graph is not undirected (missing twin arcs)")
    return twin


def partition_shapes(n: int, m: int, P: int, W: int, pad_multiple: int = 8,
                     skew: float = 2.0) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Analytic shapes of partition arrays and per-sweep message buffers.

    skew models bucket imbalance (B = skew * m / P^2). Returns name ->
    (shape, dtype)."""
    n_local = (n + P - 1) // P
    B = _ceil_to(max(int(skew * m / (P * P)), 1), pad_multiple)
    return {
        "send_src_local": ((P, P, B), "int32"),
        "send_pad": ((P, P, B), "bool"),
        "twin_recv_flat": ((P, P, B), "int32"),
        "recv_perm": ((P, P * B), "int32"),
        "recv_sorted_dst_local": ((P, P * B), "int32"),
        "recv_is_start": ((P, P * B), "bool"),
        "recv_last_edge": ((P, n_local), "int32"),
        "labels_local": ((P, n_local), "int32"),
        "vertex_valid": ((P, n_local), "bool"),
        "omega": ((P, n_local + 1, W), "uint32"),
        "edge_active": ((P, P, B), "bool"),
    }
