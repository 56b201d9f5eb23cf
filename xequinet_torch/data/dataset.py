"""Datasets and the padded-batch loader.

Copy of ``xequinet_tpu/data/dataset.py:23-258``: batches are packed
greedily into fixed (n_nodes, n_edges, n_graphs) capacities, so every
batch of a loader has one shape; with a kernel layout they also carry the
message kernels' slot layout with a fixed ``slot_cap``.  With the same
seed the loader yields the JAX loader's batches bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .batching import bucket_capacity, collate
from .datapoint import Datapoint

Transform = Callable[[Datapoint], Datapoint]


class InMemoryDataset:
    """A list of datapoints with an optional transform pipeline."""

    def __init__(
        self,
        datapoints: Sequence[Datapoint],
        transform: Optional[Transform] = None,
    ) -> None:
        self._dps = list(datapoints)
        self.transform = transform

    def __len__(self) -> int:
        return len(self._dps)

    def __getitem__(self, i: int) -> Datapoint:
        dp = self._dps[i]
        if self.transform is not None:
            dp = self.transform(dp)
        return dp


def compute_capacities(
    dataset, batch_size: int, sample: int = 256
) -> Dict[str, int]:
    """Derive padded capacities from dataset statistics: mean + 3 sigma of
    atoms/edges per graph times the batch size, bucketed."""
    n = min(len(dataset), sample)
    idx = np.linspace(0, len(dataset) - 1, n).astype(int)
    atoms, edges = [], []
    for i in idx:
        dp = dataset[int(i)]
        atoms.append(dp.num_atoms)
        edges.append(dp.num_edges)
    atoms = np.asarray(atoms)
    edges = np.asarray(edges)
    cap_nodes = bucket_capacity(
        int(batch_size * (atoms.mean() + 3 * atoms.std() / math.sqrt(batch_size)))
    )
    cap_edges = bucket_capacity(
        int(max(batch_size * (edges.mean() + 3 * edges.std() / math.sqrt(batch_size)), 1))
    )
    return {"n_nodes": cap_nodes, "n_edges": cap_edges, "n_graphs": batch_size + 1}


class DataLoader:
    """Greedy capacity packer: yields padded batch dicts of one static shape.

    Graphs that would overflow a capacity flush the current batch (the
    equivalent of the reference's DistributedSampler+DataLoader pair,
    run/train.py:100-129, re-designed for static shapes).  Graphs larger
    than the whole capacity are skipped and counted in ``.n_dropped``.
    ``process_shard`` = (rank, world): each process iterates a disjoint
    strided slice of the same seeded permutation (the DistributedSampler
    equivalent).  Arrays are float32.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        capacities: Optional[Dict[str, int]] = None,
        shuffle: bool = False,
        seed: int = 0,
        process_shard: Optional[Tuple[int, int]] = None,
        kernel_layout: Optional[Dict[str, int]] = None,
        prefetch: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.caps = capacities or compute_capacities(dataset, batch_size)
        # kernel-route slot layout (v2, mega): fix the flat slot capacity from
        # the bucket capacities so EVERY batch compiles to one program
        self.kernel_layout = None
        if kernel_layout is not None:
            from .batching import kernel_slot_cap

            self.kernel_layout = dict(kernel_layout)
            self.kernel_layout.setdefault(
                "slot_cap",
                kernel_slot_cap(
                    self.caps["n_nodes"], self.caps["n_edges"], kernel_layout
                ),
            )
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.n_dropped = 0
        self.process_shard = process_shard
        # >0: collate batches in a background thread with a bounded
        # queue, overlapping host batch prep with the device step (the
        # reference's DataLoader num_workers analogue; numpy releases
        # the GIL in the big array ops)
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch:
            return self._iter_prefetched()
        return self._iter_batches()

    def _iter_prefetched(self) -> Iterator[Dict[str, np.ndarray]]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        END = object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded-blocking put that aborts when the consumer is gone
            # (abandoned generator / exception mid-epoch) — otherwise the
            # producer thread would block forever holding buffered batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for b in self._iter_batches():
                    if not put(b):
                        return
                put(END)
            except BaseException as err:  # propagate into the consumer
                put(err)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

    def _iter_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        if self.process_shard is not None:
            rank, world = self.process_shard
            order = order[rank::world]
        cap_n, cap_e, cap_g = (
            self.caps["n_nodes"],
            self.caps["n_edges"],
            self.caps["n_graphs"],
        )
        buf: List[Datapoint] = []
        used_n = used_e = 0
        # kernel window bound: a molecule wider than pad_nodes cannot
        # satisfy the block-window contract (prepare_v2 would raise mid-
        # epoch) — treat it as oversized like any other capacity overflow
        max_mol = (
            self.kernel_layout["pad_nodes"]
            if self.kernel_layout is not None
            else None
        )
        for i in order:
            dp = self.dataset[int(i)]
            if (
                dp.num_atoms > cap_n
                or dp.num_edges > cap_e
                or (max_mol is not None and dp.num_atoms > max_mol)
            ):
                self.n_dropped += 1
                continue
            if (
                buf
                and (
                    used_n + dp.num_atoms > cap_n
                    or used_e + dp.num_edges > cap_e
                    or len(buf) + 1 >= cap_g
                )
            ):
                yield collate(buf, cap_n, cap_e, cap_g, kernel_layout=self.kernel_layout)
                buf, used_n, used_e = [], 0, 0
            buf.append(dp)
            used_n += dp.num_atoms
            used_e += dp.num_edges
        if buf:
            yield collate(buf, cap_n, cap_e, cap_g, kernel_layout=self.kernel_layout)

    def __len__(self) -> int:
        # upper-bound estimate (exact count depends on packing)
        n = len(self.dataset)
        if self.process_shard is not None:
            n = math.ceil(n / self.process_shard[1])
        return max(1, math.ceil(n / self.batch_size))


def calculate_stats(
    dataset, targets: Sequence[str], max_samples: int = 10000
) -> Dict[str, float]:
    """Streaming per-atom mean/std of the energy target for
    node_shift/node_scale (reference utils/functional.py:36-77)."""
    mean, m2, count = 0.0, 0.0, 0
    n = min(len(dataset), max_samples)
    for i in range(n):
        dp = dataset[i]
        if dp.energy is None:
            continue
        x = dp.energy / max(dp.num_atoms, 1)
        count += 1
        delta = x - mean
        mean += delta / count
        m2 += delta * (x - mean)
    std = math.sqrt(m2 / count) if count > 1 else 1.0
    return {"node_shift": mean, "node_scale": std if std > 0 else 1.0}
