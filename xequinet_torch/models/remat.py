"""Rematerialization of XPaiNN's message and update blocks: the port of
``nn.remat`` (``jax.checkpoint``) in ``xequinet_tpu/models/model.py:68-88``.

A block marked with :func:`remat` runs with the autograd graph it has
without remat, but its nodes keep only the block's inputs and the
parameters; every other tensor they save is a handle, rematerialized
where a backward unpacks it:

* tensors the block's forward saves (its activations) are recomputed by
  rerunning the block on its inputs;
* tensors that a force backward (``create_graph=True``) saves in the
  nodes it records for the block (the first-order VJP's intermediates)
  are recomputed by rerunning the block and its first-order VJP from
  the cotangent at the block's outputs, which is kept.

So between the force backward and the parameter-gradient pass a block
holds its inputs and that cotangent (under the ``"save_edge_agg"``
policy also the aggregate that :func:`edge_agg` names), as under
``jax.checkpoint``, and its results are those without remat bit for bit:
the graph and the order of every sum are the same, and a recompute
gives the values it saved.  At most one block's recomputed tensors are
held at a time.

The message kernels' stages run as often as the JAX program's
``pallas_call``s (3 + 3 per force call and 3 + 8 + 3 per train step at
three blocks): a recompute launches no kernel whose output nothing reads
(:func:`recomputing`: ``FusedMessage`` and ``FusedGatherScaleScatter``
return a placeholder there), nor a backward kernel whose outputs the
rerun of a first-order VJP no longer needs (:func:`spent_after`): in the
first message block, whose node inputs do not depend on the positions,
the rerun needs only the kernel's inputs (the JAX program does not rerun
it either).
"""

from __future__ import annotations

import contextvars
import functools
import weakref
from typing import Dict, List, Optional

import torch
from torch import nn

# (frame, mode) of the block running in this context; mode "forward" (the
# first run) or "recompute"
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("remat_active", default=None)


def remat(block: nn.Module, policy: str = "full") -> nn.Module:
    """Mark ``block`` for rematerialization in a ``BlockStack`` (its
    parameter names do not change).  ``policy`` "save_edge_agg" keeps the
    aggregate each message block names with :func:`edge_agg`; any other
    value recomputes everything (JAX model.py:78-83)."""
    block.remat_policy = "save_edge_agg" if policy == "save_edge_agg" else "full"
    return block


def recomputing() -> bool:
    """True while a block is rerun for its saved tensors.  An op whose
    output the block only sums into its outputs (no backward reads it)
    returns a placeholder there instead of launching its kernel."""
    active = _ACTIVE.get()
    return active is not None and active[1] == "recompute"


def edge_agg(agg: torch.Tensor) -> torch.Tensor:
    """``checkpoint_name(agg, "edge_agg")`` (JAX xpainn.py:250, :344):
    under "save_edge_agg" the block's forward keeps ``agg`` until its
    graph is freed.  No backward reads the aggregate (in the JAX program it
    is never a residual either, so XLA keeps nothing for the name): the
    policy costs that memory and spares no work."""
    active = _ACTIVE.get()
    if active is not None and active[1] == "forward" and active[0].policy == "save_edge_agg":
        active[0].aggs.append(agg.detach())
    return agg


def _plain(t: torch.Tensor) -> torch.Tensor:
    """What a pack hook keeps of a tensor: the tensor without its graph (the
    unpack puts the saved graph edge back).  Keeping the tensor itself would
    tie a node that saves its own output to itself, a cycle through the
    graph that Python's collector does not see."""
    return t.detach()


def local_graph():
    """Context of a graph an op makes and spends inside one call (a plain
    VJP on the CPU): its saves stay plain tensors, out of the handles'
    bookkeeping of a remat'd block."""
    return torch.autograd.graph.saved_tensors_hooks(_plain, lambda t: t)


# the state of the running rerun of a first-order VJP (:meth:`_Frame._rerun_vjp`)
_VJP_RERUN: contextvars.ContextVar = contextvars.ContextVar("remat_vjp_rerun", default=None)


def spent_after(n_saves: int) -> bool:
    """True in the rerun of a first-order VJP when it needs nothing past the
    running node's next ``n_saves`` saves: an op saving its inputs may then
    return placeholders for outputs that nothing will read (the rerun goes
    on to its end, on values it does not keep)."""
    state = _VJP_RERUN.get()
    if state is None:
        return False
    rank, count = state["rank"], state["count"]
    return all(r == rank and count <= j < count + n_saves
               for r, j in state["need"] - state["got"].keys())


def _skey(t: torch.Tensor):
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


class _Cache:
    """The recomputed tensors of one block: ``l1`` {save position: tensor}
    from a rerun of its forward, ``l2`` {(node rank, save position):
    tensor} from a rerun of its first-order VJP."""

    def __init__(self):
        self.owner = None
        self.l1: Optional[Dict[int, torch.Tensor]] = None
        self.l1_keys: Dict[tuple, int] = {}
        self.l2: Optional[Dict[tuple, torch.Tensor]] = None

    def holds(self, frame) -> bool:
        return self.owner is not None and self.owner() is frame

    def take(self, frame):
        if not self.holds(frame):
            self.owner = weakref.ref(frame)
            self.l1, self.l1_keys, self.l2 = None, {}, None

    def set_l1(self, l1):
        self.l1 = l1
        self.l1_keys = {_skey(t): i for i, t in l1.items()}

    def drop(self, frame_id):
        if self.owner is not None and (self.owner() is None or id(self.owner()) == frame_id):
            self.owner, self.l1, self.l1_keys, self.l2 = None, None, {}, None


_CACHE = _Cache()


class _Saved:
    """A tensor a node of a remat'd block saves.  It holds the tensor
    until the block's forward (or the node that recorded it) has run, so
    that a graph made and spent meanwhile reads it; from then on a handle
    that rematerializes it, unless it is kept ("keep": an input, a
    parameter, an integer tensor)."""

    __slots__ = ("kind", "frame", "key", "t", "__weakref__")

    def __init__(self, kind, frame, key, t):
        self.kind, self.frame, self.key, self.t = kind, frame, key, t


def _unpack(h: _Saved):
    return h.t if h.t is not None else h.frame.value(h.kind, h.key)


def _block_nodes(outs, start: int) -> list:
    """The autograd nodes the block recorded (sequence number at least
    ``start``), in the order they were recorded."""
    seen, stack, nodes = set(), [o.grad_fn for o in outs], []
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        if type(n).__name__ == "AccumulateGrad" or n._sequence_nr() < start:
            continue
        nodes.append(n)
        stack.extend(fn for fn, _ in n.next_functions)
    return sorted(nodes, key=lambda n: n._sequence_nr())


def _mark() -> int:
    """A sequence number below that of every node recorded after it."""
    return torch.zeros((), requires_grad=True).clone().grad_fn._sequence_nr()


def _slots(outs, nodes):
    rank = {n: r for r, n in enumerate(nodes)}
    return [(rank[o.grad_fn], o.output_nr) for o in outs]


class _Frame:
    """One remat'd call of a block: its inputs (the data dict), the keys of
    its outputs, the context of its forward (the halo spec), the handles'
    bookkeeping, the cotangent at its outputs from the latest force
    backward, and the kept aggregates."""

    def __init__(self, block, policy, before, context):
        self.block = block
        self.policy = policy
        self.context = context
        self.keep = {_skey(t) for t in list(before.values()) + list(block.parameters())
                     if torch.is_tensor(t)}
        self.n_packs = 0
        self.l1_pos: List[int] = []
        self.l2_keys = set()
        self.counter: Dict[int, int] = {}
        self.g1: Dict[tuple, torch.Tensor] = {}
        self.need_in: Optional[List[bool]] = None
        self.aggs: List[torch.Tensor] = []
        self.pending: list = []
        weakref.finalize(self, _CACHE.drop, id(self))

    def _kept(self, t) -> bool:
        return not t.is_floating_point() or _skey(t) in self.keep

    # -- saving -------------------------------------------------------------
    def pack_forward(self, t):
        pos = self.n_packs
        self.n_packs += 1
        if self._kept(t):
            return _Saved("keep", None, None, _plain(t))
        h = _Saved("l1", self, pos, _plain(t))
        self.pending.append(weakref.ref(h))
        return h

    def seal_forward(self):
        """After the forward: the saves still held by a node become handles."""
        for ref in self.pending:
            h = ref()
            if h is not None:
                self.l1_pos.append(h.key)
                h.t = None
        self.pending = []

    def pack_vjp(self, rank, t):
        """A save while the force backward runs the block's node ``rank``."""
        j = self.counter[rank]
        self.counter[rank] = j + 1
        if self._kept(t):
            return _Saved("keep", None, None, _plain(t))
        h = _Saved("l2", self, (rank, j), _plain(t))
        self.pending.append(weakref.ref(h))
        return h

    def seal_vjp(self):
        """After a node ran in the force backward: the saves still held by
        the nodes it recorded become handles, to a tensor of the forward's
        rerun where it is one ("v1"), else to the VJP's rerun ("l2")."""
        for ref in self.pending:
            h = ref()
            if h is None:
                continue
            pos = _CACHE.l1_keys.get(_skey(h.t)) if _CACHE.holds(self) else None
            if pos is not None:
                h.kind, h.key = "v1", pos
            else:
                self.l2_keys.add(h.key)
            h.t = None
        self.pending = []

    # -- node hooks ---------------------------------------------------------
    def pre_hook(self, rank, grad_outputs):
        """Before the block's node ``rank`` runs in a backward that records
        a graph: keep the cotangent at the block's outputs and route the
        saves of the nodes it records to :meth:`pack_vjp`."""
        if not torch.is_grad_enabled():
            return None
        for slot in self.out_slots.get(rank, ()):
            g = grad_outputs[slot]
            if g is not None:
                self.g1[(rank, slot)] = (g.detach(), g.requires_grad)
        if self.need_in is None:
            self.need_in = [x.grad_fn is None or torch._C._will_engine_execute_node(x.grad_fn)
                            for x in self.inputs]
        self.counter[rank] = 0
        torch._C._autograd._push_saved_tensors_default_hooks(
            functools.partial(self.pack_vjp, rank), _unpack)
        return None

    def post_hook(self, rank, grad_inputs, grad_outputs):
        if torch.is_grad_enabled():
            torch._C._autograd._pop_saved_tensors_default_hooks()
            self.seal_vjp()
        return None

    def attach(self, outs, start):
        nodes = _block_nodes(outs, start)
        self.slots = _slots(outs, nodes)
        self.out_slots: Dict[int, list] = {}
        for rank, slot in self.slots:
            self.out_slots.setdefault(rank, []).append(slot)
        for rank, n in enumerate(nodes):
            n.register_prehook(functools.partial(self.pre_hook, rank))
            n.register_hook(functools.partial(self.post_hook, rank))

    # -- rematerializing ----------------------------------------------------
    def value(self, kind, key):
        _CACHE.take(self)
        if kind == "l1":
            if _CACHE.l1 is None:
                _CACHE.set_l1(self.rerun(vjp=False))
            return _CACHE.l1[key]
        if _CACHE.l2 is None:
            self.rerun(vjp=True)
        return (_CACHE.l1 if kind == "v1" else _CACHE.l2)[key]

    def rerun(self, vjp: bool):
        """Rerun the block on its inputs (and, with ``vjp``, its first-order
        VJP from the kept cotangent), in the context of its forward."""
        return self.context.copy().run(self._rerun, vjp)

    def _rerun(self, vjp):
        token = _ACTIVE.set((self, "recompute"))
        try:
            with torch.enable_grad():
                d = dict(self.consts)
                leaves = [x.detach().requires_grad_() for x in self.inputs]
                d.update(zip(self.in_keys, leaves))
                packs: List[torch.Tensor] = []
                start = _mark()

                def pack(t):
                    packs.append(_plain(t))
                    return packs[-1]

                with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                    out = self.block(d)
                if len(packs) != self.n_packs:
                    raise RuntimeError(f"remat: the rerun saved {len(packs)} tensors, the "
                                       f"forward {self.n_packs}")
                l1 = {pos: packs[pos] for pos in self.l1_pos}
                if vjp:
                    _CACHE.set_l1(l1)
                    _CACHE.l2 = self._rerun_vjp([out[k] for k in self.out_keys], start,
                                                leaves)
        finally:
            _ACTIVE.reset(token)
        return None if vjp else l1

    def _rerun_vjp(self, outs, start, leaves):
        need = set(self.l2_keys)
        got: Dict[tuple, torch.Tensor] = {}
        if not need:
            return got
        nodes = _block_nodes(outs, start)
        if _slots(outs, nodes) != self.slots:
            raise RuntimeError("remat: the rerun recorded another graph than the forward")
        state = {"rank": None, "count": 0, "need": need, "got": got}

        def enter(rank, grad_outputs):
            state["rank"], state["count"] = rank, 0

        handles = [n.register_prehook(functools.partial(enter, rank))
                   for rank, n in enumerate(nodes)]

        def pack(t):
            key = (state["rank"], state["count"])
            state["count"] += 1
            t = _plain(t)
            if key in need:
                got[key] = t
            return t

        roots = [o for o, s in zip(outs, self.slots) if s in self.g1]
        cots = [g.detach().requires_grad_(rg) for g, rg in
                (self.g1[s] for s in self.slots if s in self.g1)]
        wrt = [x for x, n in zip(leaves, self.need_in) if n]
        token = _VJP_RERUN.set(state)
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                torch.autograd.grad(roots, wrt, cots, create_graph=True, allow_unused=True)
        finally:
            _VJP_RERUN.reset(token)
            for h in handles:
                h.remove()
            state.clear()
        if len(got) != len(need):
            raise RuntimeError("remat: the rerun of the first-order VJP saved other tensors "
                               "than the force backward")
        return got


def rematerialize(block: nn.Module, data: Dict, policy: str) -> Dict:
    """``block(data)`` with the block's saved tensors rematerialized."""
    if not torch.is_grad_enabled():
        return block(data)
    before = dict(data)
    frame = _Frame(block, policy, before, contextvars.copy_context())
    start = _mark()
    token = _ACTIVE.set((frame, "forward"))
    try:
        with torch.autograd.graph.saved_tensors_hooks(frame.pack_forward, _unpack):
            out = block(data)
    finally:
        _ACTIVE.reset(token)
    frame.seal_forward()
    changed = {k: v for k, v in out.items() if k not in before or v is not before[k]}
    frame.out_keys = [k for k, v in changed.items() if torch.is_tensor(v) and v.requires_grad]
    frame.in_keys = [k for k, v in before.items()
                     if torch.is_tensor(v) and v.requires_grad and v.is_floating_point()]
    frame.inputs = [before[k] for k in frame.in_keys]
    frame.consts = {k: v for k, v in before.items() if k not in frame.in_keys}
    frame.consts.update({k: v for k, v in changed.items() if k not in frame.out_keys})
    if frame.out_keys:
        frame.attach([out[k] for k in frame.out_keys], start)
    return out
