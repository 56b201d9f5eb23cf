"""Worker of the port's halo and edge-partition tests
(tests/test_torch_halo.py, tests/test_torch_halo_train.py,
tests/test_torch_edge_partition.py): one rank of a gloo process group on
the CPU, set up from torchrun's environment variables.

argv: <rank> <world> <port> <work dir>

Reads the list of cases in ``<work dir>/job.pkl``, runs every case in
order (every rank runs every case, so the collectives stay in lockstep)
and writes ``{case name: result}`` to ``<work dir>/out_<rank>.pkl``.  A
case is a dict with ``kind`` (a function below) and its arguments; model
weights travel as numpy state dicts.
"""

import os
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def _module(case):
    import torch

    from xequinet_torch.models.model import resolve_model

    module, extra, _ = resolve_model(case.get("model", "xpainn"), **case["kw"])
    module.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()})
    return module, extra


def _shard(case):
    """(gp group, dp group, this rank's (replica, shard) index)."""
    import torch.distributed as dist

    from xequinet_torch.parallel.mesh import make_groups

    gp = case.get("gp", dist.get_world_size())
    dp = dist.get_world_size() // gp
    gp_group, dp_group = make_groups(dp, gp)
    r = dist.get_rank()
    return gp_group, dp_group, r // gp, r % gp


def forward(case, work):
    """The halo forward of ``stacked`` on the case's gp group and device:
    energy, the whole [S * n_local, 3] forces (the owned rows
    all-gathered) and the kernel launches of the call."""
    from xequinet_torch.ops import cuda_build
    from xequinet_torch.ops.scatter import all_gather_rows
    from xequinet_torch.parallel.halo import local_batch, make_halo_forward

    device = case.get("device", "cpu")
    module, _ = _module(case)
    gp_group, _, _, shard = _shard(case)
    fwd = make_halo_forward(module.to(device), gp_group, case["geom"])
    cuda_build.reset_launch_counts()
    e, f = fwd(local_batch(case["stacked"], shard, device), case.get("forces", True),
               case.get("wrap_shift"))
    return {"energy": float(e), "launches": dict(cuda_build.LAUNCHES),
            "forces": None if f is None else all_gather_rows(f, gp_group).cpu().numpy()}


class GradTap:
    """An optimizer that keeps the gradients it is given and moves nothing."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def step(self):
        self.grads = [p.grad.detach().clone() for p in self.params]


def train_step(case, work):
    """One halo train step (dp x gp when the stacked arrays carry a dp axis):
    the loss and the mean gradients, and the gradients again with the
    positions moved by one f32 ulp (x (1 + 1e-7))."""
    import numpy as np

    from xequinet_torch import keys
    from xequinet_torch.parallel.halo import (local_batch, make_halo_dp_train_step,
                                              make_halo_train_step)

    module, _ = _module(case)
    gp_group, dp_group, replica, shard = _shard(case)
    dp = case["stacked"][keys.POSITIONS].ndim == 4
    index = (replica, shard) if dp else shard
    params = [p for p in module.parameters() if p.requires_grad]
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    tap = GradTap(params)
    if dp:
        step = make_halo_dp_train_step(module, gp_group, dp_group, case["geom"], tap,
                                       case["we"], case["wf"])
    else:
        step = make_halo_train_step(module, gp_group, case["geom"], tap, case["we"], case["wf"])
    out = {}
    for tag, scale in (("", 1.0), ("nudged_", 1.0 + 1e-7)):
        stacked = dict(case["stacked"])
        stacked[keys.POSITIONS] = stacked[keys.POSITIONS] * scale
        e_label = case["e_label"][replica] if dp else case["e_label"]
        wshift = None if case.get("wrap_shift") is None else (
            case["wrap_shift"][replica] if dp else case["wrap_shift"])
        loss = step(local_batch(stacked, index, "cpu"), e_label,
                    np.asarray(case["f_label"])[index], wshift)
        out[tag + "loss"] = float(loss)
        out[tag + "grads"] = {n: g.numpy() for n, g in zip(names, tap.grads)}
    return out


def gradcheck(case, work):
    """gradcheck and gradgradcheck (f64) of a round trip through the
    exchange on the case's ring: (a, b) -> E(sin(R), L * L) for (L, R) =
    E(a, b), so every rank's outputs depend on its own inputs through both
    directions and both transposes."""
    import torch

    from xequinet_torch.ops.scatter import RingExchange, make_halo_spec

    gp_group, _, _, shard = _shard(case)
    spec = make_halo_spec(gp_group, 4, 2, case["periodic"])
    gen = torch.Generator().manual_seed(shard)
    a = torch.randn(2, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    b = torch.randn(2, 3, dtype=torch.float64, generator=gen, requires_grad=True)

    def f(a, b):
        left, right = RingExchange.apply(a, b, spec)
        return RingExchange.apply(torch.sin(right), left * left, spec)

    return {"gradcheck": bool(torch.autograd.gradcheck(f, (a, b))),
            "gradgradcheck": bool(torch.autograd.gradgradcheck(f, (a, b)))}


def edge(case, work):
    """The edge-partition forward of the case's batch over the whole group:
    energy, forces and virial."""
    import torch.distributed as dist

    from xequinet_torch import keys
    from xequinet_torch.parallel.edge_partition import make_edge_parallel_forward, shard_batch
    from xequinet_torch.run.inference import batch_to_device

    module, extra = _module(case)
    if case.get("refuse"):
        try:
            make_edge_parallel_forward(module)
        except ValueError as e:
            return {"error": str(e)}
        return {"error": None}
    fwd = make_edge_parallel_forward(module)
    share = shard_batch(case["batch"], dist.get_world_size(), dist.get_rank())
    out = fwd(batch_to_device(share, "cpu"), True, case.get("virial", True))
    return {k: out[k].detach().numpy() for k in (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL)
            if k in out}


def calculator(case, work):
    """HaloCalculator over the whole group on each of the case's geometries."""
    from xequinet_torch.parallel.halo import HaloCalculator

    hc = HaloCalculator(case["ckpt"], pallas=case.get("pallas"),
                        pallas_layout=case.get("layout", (256, 1024)), use_ema=False,
                        device="cpu")
    res = [hc.calculate(case["z"], p, **case.get("sys", {})) for p in case["positions"]]
    return {"results": res, "programs": len(hc._fwd_cache)}


def md(case, work):
    """run_md with halo_devices = the group's size."""
    from xequinet_torch.run.dynamics import run_md

    state = run_md(case["config"])
    return {"pos": state.pos, "vel": state.vel}


def halo_train(case, work):
    """run_train of the case's config (gp_devices > 1) with this rank's
    save_dir; the final parameters, the config's model kwargs and the files
    this rank wrote."""
    import copy

    from xequinet_torch.run.train import run_train

    cfg = copy.deepcopy(case["config"])
    import torch.distributed as dist

    cfg.trainer.save_dir = os.path.join(work, f"run{dist.get_rank()}")
    module = run_train(cfg, device="cpu")
    files = sorted(os.listdir(cfg.trainer.save_dir)) if os.path.isdir(
        cfg.trainer.save_dir) else []
    return {"params": {n: p.detach().numpy().copy() for n, p in module.named_parameters()},
            "model_kwargs": dict(cfg.model.model_kwargs), "files": files,
            "save_dir": cfg.trainer.save_dir}


# a pool's wall limit: a deadlock fails the test within it
POOL_TIMEOUT = 240


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_pool(cases, work, world):
    """Run ``cases`` ({name: case}) in ``world`` ranks of this worker and
    return every rank's outputs, in rank order.  Every rank is waited for
    and all are killed if any outlives POOL_TIMEOUT; each must exit with 0."""
    import subprocess

    import pytest

    work = Path(work)
    with open(work / "job.pkl", "wb") as f:
        pickle.dump(cases, f)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), port, str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=POOL_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {world} ranks did not finish within {POOL_TIMEOUT} s (deadlock)")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"a rank failed:\n{out[-4000:]}"
    results = []
    for r in range(world):
        with open(work / f"out_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def main() -> int:
    rank, world, port, work = sys.argv[1:5]
    os.environ.update(RANK=rank, WORLD_SIZE=world, MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", rank=int(rank),
                            world_size=int(world))
    with open(Path(work) / "job.pkl", "rb") as f:
        cases = pickle.load(f)
    kinds = {"forward": forward, "train_step": train_step, "gradcheck": gradcheck,
             "edge": edge, "calculator": calculator, "md": md, "halo_train": halo_train}
    out = {}
    for name, case in cases.items():
        out[name] = kinds[case["kind"]](case, work)
    with open(Path(work) / f"out_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
