"""One rank of the port's multi-rank CPU tests, and the harness that runs
a world of them.

``run_world(n, cases, tmp_dir, **params)`` starts ``n`` ranks through the
port's launcher (``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node n``): each runs this file, joins a gloo world on the CPU
over a ``FileStore`` under ``tmp_dir`` (one torch thread a rank, a gloo
timeout), runs the case set ``cases`` and saves its results; the
harness waits with a timeout (a hang fails the calling test, never the
suite's clock) and returns each rank's results, in rank order. The case
sets are the functions in ``CASES``; they import torch, numpy and the
port, never JAX: the tests hold the results against the JAX package in
their own process.
"""
import json
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
GLOO_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 240


def run_world(n, cases, tmp_dir, timeout=JOIN_TIMEOUT_S, **params):
    """Run case set ``cases`` on ``n`` ranks; [rank 0's results, ...]."""
    import torch

    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    (open(os.path.join(tmp_dir, "params.json"), "w")
     .write(json.dumps(params)))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(n), "--log_dir",
           os.path.join(tmp_dir, "logs"), "--grace", "5",
           os.path.abspath(__file__), cases, tmp_dir]
    proc = subprocess.run(cmd, env=env, cwd=REPO, timeout=timeout,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        logs = []
        for r in range(n):
            p = os.path.join(tmp_dir, "logs", f"workerlog.{r}")
            if os.path.exists(p):
                logs.append(f"--- rank {r}\n" + open(p).read()[-4000:])
        raise RuntimeError(f"{cases} on {n} ranks: launcher exit "
                           f"{proc.returncode}\n{proc.stderr[-2000:]}\n"
                           + "\n".join(logs))
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


# ---------------------------------------------------------------------------
# case sets (run inside a rank)
# ---------------------------------------------------------------------------


def collective_cases(rank, n, params):
    """Every collective of the API on per-rank inputs (numpy out)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import compat
    from paddle_tpu_torch.observability import commledger as cl

    out = {}
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("avg", C.ReduceOp.AVG)):
        y = x.clone()
        C.all_reduce(y, op)
        out["all_reduce_" + name] = y.numpy()
    for i, vals in enumerate(params["prod_cases"]):
        y = torch.tensor([vals[rank % len(vals)]], dtype=torch.float32)
        C.all_reduce(y, C.ReduceOp.PROD)
        out[f"prod{i}"] = y.numpy()
    parts = []
    for axis in (0, 1):
        parts = []
        out[f"all_gather_axis{axis}"] = C.all_gather(parts, x, axis=axis
                                                     ).numpy()
    out["all_gather_parts"] = [p.numpy() for p in parts]
    yy = torch.arange(2 * n * 3, dtype=torch.float32).reshape(2 * n, 3) \
        + rank
    out["reduce_scatter"] = C.reduce_scatter(yy).numpy()
    out["reduce_scatter_list"] = C.reduce_scatter(
        torch.empty(2, 3), list(yy.chunk(n))).numpy()
    out["all_to_all"] = C.all_to_all(yy).numpy()
    lst = []
    C.all_to_all(lst, list(yy.chunk(n)))
    out["all_to_all_list"] = [t.numpy() for t in lst]
    out["alltoall_single"] = compat.alltoall_single(None, yy).numpy()
    y = x.clone()
    out["broadcast"] = C.broadcast(y, src=n - 1).numpy()
    y = torch.empty(2, 3)
    out["scatter"] = C.scatter(y, [x * (i + 1) for i in range(n)]
                               if rank == 0 else None, src=0).numpy()
    out["ppermute"] = C.ppermute(x, [(i, (i + 1) % n)
                                     for i in range(n)]).numpy()
    out["t_pmean"] = C.t_pmean(x).numpy()
    if n >= 2 and n % 2 == 0:
        sub = C.split_group(C.get_group(0), 2)
        y = torch.tensor([float(rank)])
        C.all_reduce(y, group=sub)
        out["split_group"] = (sub.ranks, y.numpy())
    # point to point: a ring (batch_isend_irecv), and a pair (send/recv)
    got = torch.zeros(2, 3)
    if n > 1:
        tasks = C.batch_isend_irecv([
            C.P2POp(C.isend, x, (rank + 1) % n),
            C.P2POp(C.irecv, got, (rank - 1) % n)])
        for t in tasks:
            t.wait()
    else:
        C.send(x, 0)
        C.recv(got, 0)
    out["p2p"] = got.numpy()
    objs = C.all_gather_object([], {"r": rank})
    out["all_gather_object"] = objs
    bl = [{"from": rank}]
    C.broadcast_object_list(bl, src=0)
    out["broadcast_object_list"] = bl
    out["gather_object"] = C.gather_object(rank * 10, dst=0)
    so = []
    compat.scatter_object_list(so, list(range(2 * n)) if rank == 0 else None,
                               src=0)
    out["scatter_object_list"] = so
    gl = []
    out["gather"] = compat.gather(x, gl, dst=0)
    out["gather"] = None if out["gather"] is None else [
        t.numpy() for t in out["gather"]]
    C.barrier()
    with cl.capture() as led:
        C.all_reduce(x.clone())
        C.t_all_gather(x)
    out["ledger"] = [(r.op, r.axis, r.p, r.payload_bytes, r.wire_bytes,
                      r.host_bytes) for r in led.records]
    out["thread_ledgers"] = _thread_ledgers(x)
    out["world"] = (C.get_rank(), C.get_world_size(), C.get_backend())
    return out


def _thread_ledgers(x):
    """Comm captures are per thread: one held open on another thread
    books nothing of this thread's all-reduce. A forward's captures are
    carried into a backward run on another thread, as a CUDA autograd
    runs it: an mp primitive's and DataParallel's gradient all-reduce.
    Each ledger's ops."""
    import threading

    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops
    from paddle_tpu_torch.distributed.parallel import DataParallel
    from paddle_tpu_torch.observability import commledger as cl

    def ops(led):
        return [r.op for r in led.records]

    opened, done, other = threading.Event(), threading.Event(), {}

    def hold():
        with cl.capture() as led:
            opened.set()
            done.wait(60)
        other["ops"] = ops(led)

    t = threading.Thread(target=hold)
    t.start()
    opened.wait(60)
    with cl.capture() as mine:
        C.all_reduce(x.clone())
    done.set()
    t.join(60)

    def backward_on_a_thread(loss):
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join(60)

    xg = x.clone().requires_grad_()
    with cl.capture() as mp_led:
        backward_on_a_thread(mp_ops.identity_psum_bwd(xg, C.get_group(0))
                             .sum())
    torch.manual_seed(0)
    model = DataParallel(torch.nn.Linear(3, 2))
    with cl.capture() as dp_led:
        backward_on_a_thread(model(x).sum())
    return {"this_thread": ops(mine), "other_thread": other["ops"],
            "mp_backward": ops(mp_led), "dp_backward": ops(dp_led),
            "xg_grad": xg.grad is not None}


def _mlp(parallel, seed):
    """The JAX tests/test_tensor_parallel.py MLP (16 -> 32 -> 16)."""
    import torch
    from torch import nn

    from paddle_tpu_torch.distributed.fleet.layers import mpu

    torch.manual_seed(seed)

    class MLP(nn.Module):
        def __init__(self):
            super().__init__()
            kw = {"device": "cpu", "has_bias": True}
            if parallel:
                self.fc1 = mpu.ColumnParallelLinear(16, 32,
                                                    gather_output=False,
                                                    **kw)
                self.fc2 = mpu.RowParallelLinear(32, 16,
                                                 input_is_parallel=True, **kw)
            else:
                self.fc1 = nn.Linear(16, 32)
                self.fc2 = nn.Linear(32, 16)

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    return MLP()


def _full_grads(model):
    """Every parameter's gradient whole, in the JAX layout (mp shards
    gathered, linear weights [in, out])."""
    import torch

    from paddle_tpu_torch.distributed import collective as C

    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        if getattr(p, "mp_group", None) is not None:
            g = C.t_all_gather(g.contiguous(), p.mp_group, axis=p.split_axis)
        out[name] = (g.T if name in linear else g).numpy()
    return out


def tensor_parallel_cases(rank, n, params):
    """The three cases of tests/test_tensor_parallel.py at mp = n (dp 1):
    the column/row MLP's loss, gradients and SGD step from the JAX
    weights; the vocab-parallel embedding forward and backward; the
    vocab-parallel cross entropy forward and backward."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import (export_jax_state_dict,
                                          load_jax_state_dict)
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.distributed.fleet.layers import mpu
    from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops
    from paddle_tpu_torch.optimizer import SGD

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": n}
    hcg = fleet.init(is_collective=True, strategy=s)
    out = {}
    # 1. column -> row MLP: one SGD step through the engine
    model = _mlp(True, 0)
    load_jax_state_dict(model, {k: np.asarray(v) for k, v in
                                params["mlp_state"].items()}, hcg=hcg)
    x = torch.tensor(np.asarray(params["x"], np.float32))
    y = torch.tensor(np.asarray(params["y"], np.float32))
    xg = x.clone().requires_grad_(True)
    loss = torch.mean((model(xg) - y) ** 2)
    loss.backward()
    out["mlp_loss"] = float(loss)
    out["mlp_input_grad"] = xg.grad.numpy()
    out["mlp_grads"] = _full_grads(model)
    for p in model.parameters():
        p.grad = None
    opt = SGD(learning_rate=0.1, parameters=model.named_parameters())
    step = ParallelEngine(model, opt, hcg.mesh).train_step(
        lambda m, b: torch.mean((m(b["x"]) - b["y"]) ** 2))
    out["mlp_step_loss"] = float(step({"x": x, "y": y}))
    out["mlp_after"] = export_jax_state_dict(model)
    # 2. vocab-parallel embedding, forward and backward
    emb = mpu.VocabParallelEmbedding(64, 16, device="cpu")
    load_jax_state_dict(emb, {"weight": np.asarray(params["emb"])})
    e = emb(torch.tensor(np.asarray(params["ids"])))
    (e * torch.tensor(np.asarray(params["emb_cot"], np.float32))
     ).sum().backward()
    out["emb_out"] = e.detach().numpy()
    out["emb_grad"] = _full_grads(emb)["weight"]
    # 3. vocab-parallel cross entropy over _c_split logits
    logits = torch.tensor(np.asarray(params["logits"], np.float32),
                          requires_grad=True)
    labels = torch.tensor(np.asarray(params["labels"]))
    local = mp_ops._c_split(logits)
    ce = mpu.parallel_cross_entropy(local, labels)
    (ce.squeeze(-1) * torch.tensor(np.asarray(params["ce_cot"], np.float32))
     ).sum().backward()
    out["ce"] = ce.detach().numpy()
    out["ce_grad"] = logits.grad.numpy()
    out["mp_rank"] = hcg.get_model_parallel_rank()
    return out


def reducer_cases(rank, n, params):
    """DataParallel over n ranks: each rank's own batch block; the
    averaged gradients (one bucket, and per-parameter buckets); no_sync
    accumulation kept."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.distributed.parallel import DataParallel

    state = {k: np.asarray(v) for k, v in params["state"].items()}
    X = torch.tensor(np.asarray(params["x"], np.float32))
    Y = torch.tensor(np.asarray(params["y"], np.float32))
    b = X.shape[0] // n
    x, y = X[rank * b:(rank + 1) * b], Y[rank * b:(rank + 1) * b]
    out = {}
    for name, mb in (("one_bucket", 1000), ("per_param", 1e-9)):
        m = _seq()
        load_jax_state_dict(m, state)
        dp = DataParallel(m, comm_buffer_size=mb)
        torch.mean((dp(x) - y) ** 2).backward()
        out[name] = {k: p.grad.numpy() for k, p in m.named_parameters()}
        out[name + "_fires"] = (dp._reducer.fused_reduce_count,
                                dp._reducer.num_buckets)
    m = _seq()
    load_jax_state_dict(m, state)
    dp = DataParallel(m, comm_buffer_size=1000)
    with dp.no_sync():
        torch.mean((dp(x) - y) ** 2).backward()
    out["no_sync_fires"] = dp._reducer.fused_reduce_count
    torch.mean((dp(x) - y) ** 2).backward()
    out["accumulated"] = {k: p.grad.numpy() for k, p in m.named_parameters()}
    return out


def _seq():
    """The JAX tests/test_dp_reducer.py model: 8 -> 32 -> ReLU -> 4."""
    from torch import nn

    return nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))


PEAK_FLOPS = 1e12     # a card's peak FLOP/s, for the MFU gauge's arithmetic


def hybrid_gpt_cases(rank, n, params):
    """gpt_tiny through fleet.init + ParallelEngine at (dp, mp): the JAX
    weights loaded (sharded by convert), then 3 steps of each optimizer
    run; the losses and the gathered parameters; the sharded load /
    export round trip."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import (export_jax_state_dict,
                                          load_jax_state_dict)
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.observability import flops
    from paddle_tpu_torch.optimizer import SGD, AdamW

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": params["dp"],
                        "mp_degree": params["mp"]}
    hcg = fleet.init(is_collective=True, strategy=s)
    state = {k: np.asarray(v) for k, v in params["state"].items()}
    x = torch.tensor(np.asarray(params["x"]))
    y = torch.tensor(np.asarray(params["y"]))
    out = {}
    for run, (kind, lr, clip) in params["runs"].items():
        model = tg.GPTForCausalLM(tg.gpt_tiny(), device="cpu", seed=7)
        load_jax_state_dict(model, state)
        if run == "sgd":
            back = export_jax_state_dict(model)
            out["round_trip"] = all(np.array_equal(back[k], state[k])
                                    for k in state) and set(back) == set(
                state)
            out["local_shapes"] = {k: tuple(p.shape) for k, p in
                                   model.named_parameters()}
        opt = (SGD if kind == "sgd" else AdamW)(
            learning_rate=lr, parameters=model.named_parameters(),
            grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
        crit = tg.GPTPretrainingCriterion()
        eng = ParallelEngine(model, opt, hcg.mesh)
        eng._peak_flops = PEAK_FLOPS    # the CPU has no peak: a stand-in
        step = eng.train_step(lambda m, b: crit(m(b["x"]), b["y"]))
        losses = [float(step({"x": x, "y": y})) for _ in range(3)]
        out[run] = {"losses": losses, "final": export_jax_state_dict(model),
                    "grad_norm": float(opt.grad_norm)
                    if opt.grad_norm is not None else None}
        if run == "sgd":
            m = eng._metrics
            out["telemetry"] = dict(
                eng.pod_throughput(), mfu=m["mfu"].value(),
                tokens_per_sec=m["tokens_per_sec"].value(),
                flops_per_token=flops.train_flops_per_token(
                    model.config.num_params(), config=model.config))
    out["coords"] = hcg.mesh.coords
    return out


def launch_env_cases(rank, n, params):
    """What the launcher exported, and a failure on request."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT", "PADDLE_TRAINER_ID",
            "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK", "PADDLE_MASTER")
    if params.get("fail_rank") == rank:
        raise SystemExit(params.get("exit_code", 3))
    return {k: os.environ.get(k) for k in keys}


def write_rank(out_dir):
    """``compat.spawn``'s target in the tests: the rank variables it set,
    into out_dir/spawn.<rank>."""
    rank = os.environ["PADDLE_TRAINER_ID"]
    with open(os.path.join(out_dir, f"spawn.{rank}"), "w") as f:
        f.write(json.dumps({k: os.environ[k] for k in (
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "PADDLE_TRAINERS_NUM")}))


CASES = {"collective": collective_cases,
         "tensor_parallel": tensor_parallel_cases,
         "reducer": reducer_cases, "hybrid_gpt": hybrid_gpt_cases,
         "launch_env": launch_env_cases}


def main(cases, tmp_dir):
    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    params = json.loads(open(os.path.join(tmp_dir, "params.json")).read())
    rank = int(os.environ["RANK"])
    n = int(os.environ["WORLD_SIZE"])
    if cases == "launch_env":
        result = launch_env_cases(rank, n, params)
    else:
        from paddle_tpu_torch.distributed import collective as C

        C.init_parallel_env(device="cpu", timeout=GLOO_TIMEOUT_S,
                            init_method="file://" + os.path.join(
                                tmp_dir, "store"))
        result = CASES[cases](rank, n, params)
        C.barrier()
        C.destroy_process_group()
    torch.save(result, os.path.join(tmp_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
