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


def _fleet_init(dp, mp, **hybrid):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict({"dp_degree": dp, "mp_degree": mp}, **hybrid)
    return fleet.init(is_collective=True, strategy=s)


def hybrid_llama_cases(rank, n, params):
    """llama_tiny through fleet.init + ParallelEngine at (dp, mp): the
    seeded initialisation gathered; the JAX weights loaded (sharded by
    convert) and exported back; AdamW runs with and without clip 1.0; an
    SGD run with a loss mask, one with the tied head; train_step and
    eval_step with batch_specs (a replicated leaf beside dp-split ones);
    what the cached paths raise."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import (export_jax_state_dict,
                                          load_jax_state_dict)
    from paddle_tpu_torch.distributed.engine import P, ParallelEngine
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD, AdamW

    hcg = _fleet_init(params["dp"], params["mp"])
    arr = {k: torch.tensor(np.asarray(params[k])) for k in ("x", "y", "mask",
                                                            "w")}
    crit = tl.LlamaPretrainingCriterion()
    out = {"coords": hcg.mesh.coords}
    out["init"] = export_jax_state_dict(
        tl.LlamaForCausalLM(tl.llama_tiny(), device="cpu", seed=7))

    def model(tied=False):
        m = tl.LlamaForCausalLM(tl.llama_tiny(tie_word_embeddings=tied),
                                device="cpu", seed=7)
        load_jax_state_dict(m, {k: np.asarray(v) for k, v in params[
            "state_tied" if tied else "state"].items()})
        return m

    m = model()
    back = export_jax_state_dict(m)
    out["round_trip"] = set(back) == set(params["state"]) and all(
        np.array_equal(back[k], np.asarray(params["state"][k]))
        for k in back)
    out["local_shapes"] = {k: tuple(p.shape) for k, p in m.named_parameters()}
    runs = {"adamw": (AdamW, 1e-3, None, False, False, 3),
            "adamw_clip": (AdamW, 1e-3, 1.0, False, False, 3),
            "masked": (SGD, 0.05, None, False, True, 2),
            "tied": (SGD, 0.05, None, True, False, 2)}
    for run, (cls, lr, clip, tied, masked, steps) in runs.items():
        m = model(tied)
        opt = cls(learning_rate=lr, parameters=m.named_parameters(),
                  grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
        step = ParallelEngine(m, opt, hcg.mesh).train_step(
            lambda mm, b: crit(mm(b["x"]), b["y"],
                               b["mask"] if masked else None))
        batch = {"x": arr["x"], "y": arr["y"], "mask": arr["mask"]}
        out[run] = {"losses": [float(step(batch)) for _ in range(steps)],
                    "final": export_jax_state_dict(m)}
    # batch_specs: keys sorted, so (w, x, y); w [S] whole on every rank
    specs = (P(), P("dp"), P("dp"))
    m = model()
    eng = ParallelEngine(m, SGD(learning_rate=0.05,
                                parameters=m.named_parameters()), hcg.mesh)
    batch = {"w": arr["w"], "x": arr["x"], "y": arr["y"]}
    ev = eng.eval_step(lambda mm, b: mm(b["x"]), batch_specs=specs)
    out["eval_logits"] = ev(batch, out_spec=P("dp", None, "mp")).numpy()
    step = eng.train_step(
        lambda mm, b: crit(mm(b["x"]), b["y"],
                           b["w"][None].expand_as(b["y"])),
        batch_specs=specs)
    out["specs"] = {"losses": [float(step(batch)) for _ in range(2)],
                    "final": export_jax_state_dict(m)}
    out["eval_stats"] = (eng.stats.compiles, eng.stats.cache_hits)
    # the cached paths under an mp group
    raised = {}
    m = model()
    ids = arr["x"][:2, :4]
    for name, call in (
            ("generate", lambda: m.generate(ids, max_new_tokens=2)),
            ("static", lambda: m(ids, m._empty_caches(2, 8), offset=0)),
            ("paged", lambda: m(ids, [(torch.zeros(4, 1, 8, 16),
                                       torch.zeros(4, 1, 8, 16),
                                       torch.zeros(2, 1, dtype=torch.int32))]
                                * 2, offset=0))):
        try:
            call()
            raised[name] = None
        except RuntimeError as e:
            raised[name] = str(e)
    out["raised"] = raised
    return out


SP_OPS = ("scatter", "gather", "all_gather", "reduce_scatter")


def _sp_block(norm, d=16, h=32):
    """The JAX tests/test_sharding_sp.py SPBlock on [b, s, d]: the
    sequence scattered, the norm on a shard, column / row sequence-parallel
    linears, the sequence gathered; the norm's parameters marked."""
    import torch
    from torch import nn

    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as spu
    from paddle_tpu_torch.models.llama import LlamaRMSNorm

    class SPBlock(nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = (nn.LayerNorm(d) if norm == "layer_norm" else
                         LlamaRMSNorm(d, 1e-5, device="cpu"))
            self.fc1 = spu.ColumnSequenceParallelLinear(
                d, h, gather_output=False, seq_axis=1, device="cpu")
            self.fc2 = spu.RowSequenceParallelLinear(
                h, d, input_is_parallel=True, seq_axis=1, device="cpu")
            for p in self.norm.parameters():
                spu.mark_as_sequence_parallel_parameter(p)

        def forward(self, x):
            x = spu.scatter(x, axis=1)
            x = torch.relu(self.fc1(self.norm(x)))
            return spu.gather(self.fc2(x), axis=1)

    return SPBlock()


def sequence_parallel_cases(rank, n, params):
    """The SP primitives on this rank's own input and cotangent (indexed
    by its mp rank), forward and input gradient; with dp > 1 the SPBlock
    (LayerNorm and LlamaRMSNorm) for 3 Adam steps through the engine,
    its marked parameters, the hooks' list and the booked bytes; then 3
    eager steps through fleet.distributed_model / distributed_optimizer
    (the marked gradients after each sync, the losses' mean over ranks)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import (export_jax_state_dict,
                                          load_jax_state_dict)
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as spu
    from paddle_tpu_torch.observability import commledger as cl
    from paddle_tpu_torch.optimizer import Adam

    hcg = _fleet_init(params["dp"], params["mp"])
    r = hcg.get_model_parallel_rank()
    out = {"prims": {}}
    for op in SP_OPS:
        case = params["prims"][op]
        x = torch.tensor(np.asarray(case["x"][r], np.float32),
                         requires_grad=True)
        y = getattr(spu, op)(x, axis=1)
        (y * torch.tensor(np.asarray(case["g"][r], np.float32))
         ).sum().backward()
        out["prims"][op] = (y.detach().numpy(), x.grad.numpy())
    out["alias"] = np.array_equal(
        spu.ScatterOp.apply(x.detach(), axis=1).numpy(),
        spu.scatter(x.detach(), axis=1).numpy())
    if params["dp"] == 1:
        return out
    xb = torch.tensor(np.asarray(params["x"], np.float32))
    yb = torch.tensor(np.asarray(params["y"], np.float32))
    for norm in ("layer_norm", "rms_norm"):
        m = _sp_block(norm)
        load_jax_state_dict(m, {k: np.asarray(v) for k, v in
                                params["state"][norm].items()})
        hooks = spu.register_sequence_parallel_allreduce_hooks(m)
        names = {id(p): k for k, p in m.named_parameters()}
        eng = ParallelEngine(m, Adam(learning_rate=0.1,
                                     parameters=m.named_parameters()),
                             hcg.mesh)
        step = eng.train_step(
            lambda mm, b: torch.mean((mm(b["x"]) - b["y"]) ** 2))
        losses = []
        for i in range(3):
            if i == 2:
                with cl.capture() as led:
                    losses.append(float(step({"x": xb, "y": yb})))
            else:
                losses.append(float(step({"x": xb, "y": yb})))
        marked = torch.cat([p.detach().reshape(-1) for p in hooks])
        every = C.t_all_gather(marked, C.get_group(0), tiled=False)
        booked = {}
        for rec in led.records:
            key = f"{rec.axis}/{rec.op}"
            booked[key] = booked.get(key, 0) + rec.payload_bytes
        out[norm] = {"losses": losses, "final": export_jax_state_dict(m),
                     "hooks": sorted(names[id(p)] for p in hooks),
                     "marked_equal": all(torch.equal(every[0], every[i])
                                         for i in range(1, n)),
                     "booked": booked,
                     "local_shapes": {k: tuple(p.shape) for k, p in
                                      m.named_parameters()}}
        # Paddle's eager SP recipe: distributed_model, distributed_optimizer,
        # the hooks call, each rank on its dp block of the batch
        m = _sp_block(norm)
        load_jax_state_dict(m, {k: np.asarray(v) for k, v in
                                params["state"][norm].items()})
        model = tfleet.distributed_model(m)
        opt = tfleet.distributed_optimizer(
            Adam(learning_rate=0.1, parameters=m.named_parameters()))
        hooks = spu.register_sequence_parallel_allreduce_hooks(m)
        dp = hcg.get_data_parallel_rank()
        blk = slice(dp * 2, dp * 2 + 2)
        losses, grads_equal = [], []
        for _ in range(3):
            loss = torch.mean((model(xb[blk]) - yb[blk]) ** 2)
            loss.backward()
            opt.step()
            g = torch.cat([p.grad.reshape(-1) for p in hooks])
            every = C.t_all_gather(g, C.get_group(0), tiled=False)
            grads_equal.append(all(torch.equal(every[0], every[i])
                                   for i in range(1, n)))
            opt.clear_grad()
            losses.append(float(C.t_pmean(loss.detach().reshape(1),
                                          C.get_group(0))))
        marked = torch.cat([p.detach().reshape(-1) for p in hooks])
        every = C.t_all_gather(marked, C.get_group(0), tiled=False)
        out[norm]["eager"] = {
            "losses": losses, "final": export_jax_state_dict(m),
            "grads_equal": grads_equal,
            "marked_equal": all(torch.equal(every[0], every[i])
                                for i in range(1, n))}
    return out


def recompute_cases(rank, n, params):
    """The JAX test_recompute_inside_engine at dp n: a 16 -> 32 -> 16 MLP
    under ``recompute`` inside the model's forward, 2 Adam steps (lr 0.1)
    through the engine; the losses and the final parameters. Then a
    masked mean over the dp split (``_masked_mean_over_splits``) computed
    inside the recomputed block and the same block run plainly, 2 steps
    each."""
    import numpy as np
    import torch
    from torch import nn

    from paddle_tpu_torch.convert import (export_jax_state_dict,
                                          load_jax_state_dict)
    from paddle_tpu_torch.distributed.engine import ParallelEngine
    from paddle_tpu_torch.distributed.fleet import recompute
    from paddle_tpu_torch.models.llama import _masked_mean_over_splits
    from paddle_tpu_torch.optimizer import Adam

    hcg = _fleet_init(n, 1)

    class RematMLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.block = _mlp(False, 0)

        def forward(self, x):
            return recompute(self.block, x)

    m = RematMLP()
    load_jax_state_dict(m.block, {k: np.asarray(v)
                                  for k, v in params["state"].items()})
    step = ParallelEngine(m, Adam(learning_rate=0.1,
                                  parameters=m.named_parameters()),
                          hcg.mesh).train_step(
        lambda mm, b: torch.mean((mm(b["x"]) - b["y"]) ** 2))
    b = {k: torch.tensor(np.asarray(params[k], np.float32))
         for k in ("x", "y")}
    out = {"losses": [float(step(b)) for _ in range(2)],
           "final": export_jax_state_dict(m.block)}
    # a masked mean across the dp split inside the recomputed block: rank
    # 0's block mostly kept, rank 1's mostly masked, so the local and
    # global denominators differ
    r = np.random.RandomState(4)
    xm, ym = r.randn(2, 4, 6, 16), r.randn(2, 4, 6, 16)
    keep = (r.rand(4, 6) < np.array([[0.9], [0.9], [0.2], [0.2]])) * 1.0
    keep[3, 0] = 1.0
    bm = {"x": torch.tensor(xm, dtype=torch.float32),
          "y": torch.tensor(ym, dtype=torch.float32),
          "mask": torch.tensor(keep, dtype=torch.float32)}

    class MaskedLoss(nn.Module):
        def __init__(self, remat):
            super().__init__()
            self.block, self.remat = _mlp(False, 0), remat

        def loss(self, x, y, mask):
            err = ((self.block(x) - y) ** 2).mean(-1)
            return _masked_mean_over_splits((err * mask).sum(), mask.sum())

        def forward(self, x, y, mask):
            if self.remat:
                return recompute(self.loss, x, y, mask)
            return self.loss(x, y, mask)

    for run in ("plain", "recompute"):
        m = MaskedLoss(run == "recompute")
        load_jax_state_dict(m.block, {k: np.asarray(v)
                                      for k, v in params["state"].items()})
        step = ParallelEngine(m, Adam(learning_rate=0.1,
                                      parameters=m.named_parameters()),
                              hcg.mesh).train_step(
            lambda mm, bb: mm(bb["x"], bb["y"], bb["mask"]))
        out["masked_" + run] = {
            "losses": [float(step({k: v[i] if v.dim() == 4 else v
                                   for k, v in bm.items()}))
                       for i in range(2)],
            "final": export_jax_state_dict(m.block)}
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
         "hybrid_llama": hybrid_llama_cases,
         "sequence_parallel": sequence_parallel_cases,
         "recompute": recompute_cases,
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
