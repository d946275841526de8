"""The ranks of the port's data-parallel tests, and the helper that starts them.

``start(case, workdir)`` runs ``python -m tests.torch_parallel_ranks CASE
WORKDIR`` once a rank, with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free localhost port); ``join()`` waits for them within
a timeout, kills every rank still running at its end, and raises with each
rank's output if one failed. Each rank joins a ``gloo`` group on the CPU
with an init timeout (``INIT_TIMEOUT_S``), reads its inputs from
``WORKDIR/<case>.pt`` (written by the test) and writes
``WORKDIR/<case>_rank<r>.pt``.

This module imports torch and the port only, never jax, nor a test module
that imports it: the ranks are fresh interpreters.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
INIT_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` rank processes of ``case``; ``join`` waits for them."""

    def __init__(self, case: str, workdir: Path, world: int = 2, env=None):
        self.case, self.workdir, self.world = case, Path(workdir), world
        base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                    WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="2",
                    **(env or {}))
        self.logs = [self.workdir / f"{case}_rank{r}.log" for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_parallel_ranks", case, str(workdir)],
                    cwd=ROOT, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                    stderr=subprocess.STDOUT))

    def outputs(self) -> str:
        return "\n".join(f"--- rank {r} ---\n{p.read_text()[-4000:]}"
                         for r, p in enumerate(self.logs))

    def join(self, timeout: float = JOIN_TIMEOUT_S) -> list:
        """Waits for every rank; returns each rank's result file's payload."""
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{self.case}: the ranks did not end within {timeout} s\n"
                                 + self.outputs()) from None
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in self.procs]
        if any(rcs):
            raise AssertionError(f"{self.case}: rank exit codes {rcs}\n" + self.outputs())
        return [torch.load(self.workdir / f"{self.case}_rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def start(case: str, workdir: Path, world: int = 2, env=None) -> Ranks:
    return Ranks(case, workdir, world, env)


# --------------------------------------------------------------- the cases
def case_collectives(group, inputs):
    """The collectives' semantics on rank ``group.rank``."""
    from iou3dmatch_tpu_torch.parallel import collectives as col
    from iou3dmatch_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from iou3dmatch_tpu_torch.train.state import create_train_state

    r, out = group.rank, {}
    x = torch.full((3,), float(r + 1), dtype=torch.float64, requires_grad=True)
    outside = col.all_reduce_sum(x)
    out["outside_is_input"] = outside is x
    with col.active(group):
        # each rank's loss is w_r * sum(y), y = sum over ranks of 2x: the
        # global loss is (w_0 + w_1) sum(y), so x.grad = 2 (w_0 + w_1)
        y = col.all_reduce_sum(2 * x)
        (inputs["weights"][r] * y.sum()).backward()
        out["y"], out["x_grad"] = y.detach(), x.grad.clone()
        out["global_sum"] = col.global_sum(torch.tensor([r + 1.0, 10.0 * r]))
        # rank r holds the mean r + 1 of r + 2 items
        out["global_mean"] = col.global_mean(torch.tensor([r + 1.0]), r + 2)
        out["world"] = col.world()
        params = [torch.nn.Parameter(torch.zeros(2, 2)), torch.nn.Parameter(torch.zeros(3))]
        params[0].grad = torch.full((2, 2), float(r + 1))
        params[1].grad = torch.full((3,), 10.0 * (r + 1))
        col.all_reduce_grads(params)
        out["grads"] = [p.grad.clone() for p in params]
        out["metrics"] = col.all_reduce_metrics({"a": torch.tensor(r + 0.5),
                                                 "b": torch.tensor(2.0 * r, dtype=torch.float64)})
    # replicate: each rank builds a model of its own seed; rank 0's wins
    from iou3dmatch_tpu_torch.models.factory import build_votenet

    model, _ = build_votenet("scannet", tiny=True, device="cpu",
                             generator=torch.Generator().manual_seed(100 + r))
    state = create_train_state(model, with_ema=True)
    with torch.no_grad():
        state.ema_model.backbone_net.sa1.mlp_module.layer0.bn.bn.running_mean.add_(r)
    replicate(state, group)
    out["replicated"] = {**{f"model.{k}": v for k, v in model.state_dict().items()},
                         **{f"ema.{k}": v for k, v in state.ema_model.state_dict().items()}}
    out["shard"] = shard_batch(inputs["batch"], group, num_labeled=inputs["num_labeled"])
    # a group of the first rank alone: rank 1 is outside it
    sub = make_mesh(1)
    out["sub"] = None if sub is None else (sub.rank, sub.world)
    if sub is not None:
        with col.active(sub):
            out["sub_sum"] = col.all_reduce_sum(torch.tensor([5.0]))
    out["counts"] = dict(col.COUNTS)
    return out


def case_bn(group, inputs):
    """Train-mode BatchNorm on this rank's rows of each input, under the
    group: its output, the input's gradient, the parameters' gradients summed
    over the ranks, and the running statistics."""
    from iou3dmatch_tpu_torch.models.mlp import BatchNorm
    from iou3dmatch_tpu_torch.parallel import collectives as col

    out = []
    for case in inputs["cases"]:
        rows = case["rows"][group.rank]
        x = case["x"][rows[0]:rows[1]].clone().requires_grad_(True)
        bn = BatchNorm(x.shape[-1]).to(x.dtype)
        bn.load_state_dict(case["state"])
        bn.momentum = case["momentum"]
        with col.active(group):
            y = bn(x)
            y.backward(case["g"][rows[0]:rows[1]])
            col.all_reduce_grads(bn.parameters())
        out.append({"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
                    "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
                    "running_var": bn.running_var})
    return out


def snapshot(state) -> dict:
    """The state a step leaves: both models' parameters and buffers, and the
    student's gradients."""
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema_model.state_dict().items()}
            if state.ema_model is not None else {},
            "grads": {k: p.grad.clone() for k, p in state.model.named_parameters()
                      if p.grad is not None},
            "step": state.step}


def run_steps(case, group=None):
    """``case``'s steps from its global batch and weights: on this rank's rows
    under ``shard_train_step`` with ``group``, or on the whole batch in one
    process without it. Returns, for each step, its metrics and
    ``snapshot``."""
    from iou3dmatch_tpu_torch.data.config import get_config
    from iou3dmatch_tpu_torch.models.factory import build_votenet
    from iou3dmatch_tpu_torch.parallel import shard_batch, shard_train_step
    from iou3dmatch_tpu_torch.train.state import create_train_state
    from iou3dmatch_tpu_torch.train.steps import make_pretrain_step, make_ssl_step

    dtype = case["dtype"]
    model, _ = build_votenet(case["dataset"], tiny=True, device="cpu", sampling=case["sampling"],
                             compute_dtype=case.get("compute_dtype"))
    model.load_state_dict(case["model"], strict=True)
    state = create_train_state(model, adam_eps=case["adam_eps"], with_ema=case["ssl"])
    if case["ssl"]:
        state.ema_model.load_state_dict(case["ema"], strict=True)
    batch, noise = case["batch"], case["noise"]
    if dtype == torch.float64:
        model.double()
        if state.ema_model is not None:
            state.ema_model.double()
        batch = {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()}
        if noise is not None:
            noise = tuple(tuple(x.double() for x in pair) for pair in noise) if case["ssl"] \
                else tuple(x.double() for x in noise)
    cfg = get_config(case["dataset"])
    world = 1 if group is None else group.world
    if case["ssl"]:
        step = make_ssl_step(cfg, case["num_labeled"] // world, dataset=case["dataset"],
                             **case["thresholds"], **case["knobs"])
    else:
        step = make_pretrain_step(cfg)
    if group is not None:
        batch = shard_batch(batch, group, case["num_labeled"])
        step = shard_train_step(step, group)
    out = []
    for i in range(case["steps"]):
        metrics = step(state, batch, case["lr"], case["momentum"],
                       noise=noise if i == 0 else None)
        out.append({"metrics": {k: v.clone() for k, v in metrics.items()}, **snapshot(state)})
    return out


def case_steps(group, inputs):
    return {name: run_steps(case, group) for name, case in inputs["cases"].items()}


def main():
    case, workdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(2)
    if case == "driver":
        # the SSL driver as torchrun starts it: it joins the group itself
        from iou3dmatch_tpu_torch.cli import train

        argv = torch.load(workdir / "driver.pt", weights_only=False)["argv"]
        train.main(argv)
        result = {"rank": int(os.environ["RANK"])}
    else:
        from iou3dmatch_tpu_torch.parallel import distributed

        group = distributed.initialize_distributed(device_type="cpu",
                                                   timeout_s=INIT_TIMEOUT_S)
        try:
            inputs = torch.load(workdir / f"{case}.pt", weights_only=False)
            result = {"collectives": case_collectives, "bn": case_bn,
                      "steps": case_steps}[case](group, inputs)
        finally:
            distributed.shutdown()
    torch.save(result, workdir / f"{case}_rank{os.environ['RANK']}.pt")


if __name__ == "__main__":
    main()
