"""The port's SelectedRows gradient path held against the JAX package's
on the CPU (tests/test_sparse_csr_selected_rows.py there): ``SelectedRows``
and its merge, ``Embedding(sparse=True)`` and its padding rows, the
global-norm clip over sparse and dense gradients, SGD's row update and
Adam / AdamW with and without ``lazy_mode``, 5 steps each.

Weights come from the JAX layers (seeded) as numpy and pass to the port;
ids and labels from a seeded numpy generator. Tolerance 1e-6 of each
tensor's largest magnitude: duplicate rows are summed in another order
than the JAX merge's, and XLA's CPU backend fuses multiply-adds that
torch rounds twice.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.framework import SelectedRows as JSelectedRows
from paddle_tpu.framework import merge_selected_rows as jmerge
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework.selected_rows import (SelectedRows,
                                                      merge_selected_rows)
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.common import Embedding

TOL = 1e-6


def _close(mine, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(mine), ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1.0))


def test_merge_and_to_dense_match_jax():
    r = np.random.RandomState(0)
    rows = r.randint(0, 9, 12)
    vals = r.randn(12, 3).astype(np.float32)
    mine = merge_selected_rows(SelectedRows(rows, torch.tensor(vals), 9))
    ref = jmerge(JSelectedRows(rows, vals, 9))
    _close(mine.to_dense(), ref.to_dense_value())
    _close(SelectedRows(rows, torch.tensor(vals), 9).to_dense(),
           JSelectedRows(rows, vals, 9).to_dense_value())
    # the JAX merge parks freed slots at row `height`; the port keeps the
    # unique rows only, ascending
    keep = np.asarray(ref.rows) < 9
    assert mine.rows.tolist() == np.asarray(ref.rows)[keep].tolist()
    _close(mine.values, np.asarray(ref.values)[keep])
    assert mine.shape == [9, 3] and mine.height == 9
    assert mine.is_selected_rows() and mine.merge().rows.tolist() == \
        mine.rows.tolist()


@pytest.mark.parametrize("padding_idx", [None, 0, -1])
def test_sparse_embedding_gradient_matches_jax(padding_idx):
    """The weight's gradient holds only the looked-up rows (duplicates
    kept, summed on merge), padding rows zeroed but present, as the JAX
    SelectedRows; the lookup and the padding row zeroed at init too."""
    paddle.seed(0)
    jemb = jnn.Embedding(20, 4, sparse=True, padding_idx=padding_idx)
    temb = Embedding(20, 4, sparse=True, padding_idx=padding_idx,
                     device="cpu")
    with torch.no_grad():
        temb.weight.copy_(torch.tensor(np.asarray(jemb.weight._value)))
    if padding_idx is not None:
        row = padding_idx % 20
        assert not temb.weight[row].any()
        assert not np.asarray(jemb.weight._value)[row].any()
    ids = np.array([[1, 3, 19], [3, 0, 7]])
    g = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    jout = jemb(paddle.to_tensor(ids))
    (jout * paddle.to_tensor(g)).sum().backward()
    tout = temb(torch.tensor(ids))
    (tout * torch.tensor(g)).sum().backward()
    _close(tout.detach(), jout._value)
    grad = temb.weight.grad
    assert grad.is_sparse and grad._values().shape == (6, 4)
    sr = SelectedRows.from_coo(grad)
    assert sr.rows.tolist() == ids.reshape(-1).tolist()
    _close(sr.to_dense(), jemb.weight.grad.to_dense_value())


def test_sparse_embedding_needs_a_leaf_weight():
    from paddle_tpu_torch.core.enforce import PreconditionNotMetError
    from paddle_tpu_torch.nn.sparse_embedding import sparse_embedding

    w = torch.randn(5, 2, requires_grad=True)
    with pytest.raises(PreconditionNotMetError, match="leaf"):
        sparse_embedding(torch.tensor([1]), w * 2)
    with torch.no_grad():
        assert torch.equal(sparse_embedding(torch.tensor([1]), w * 2),
                           (w * 2)[1:2])


def _train_jax(sparse, opt_cls, steps, **kw):
    paddle.seed(7)
    emb = jnn.Embedding(30, 8, sparse=sparse)
    lin = jnn.Linear(8, 2)
    w0 = (np.asarray(emb.weight._value), np.asarray(lin.weight._value),
          np.asarray(lin.bias._value))
    opt = opt_cls(learning_rate=0.1,
                  parameters=list(emb.parameters()) + list(lin.parameters()),
                  **kw)
    r = np.random.RandomState(3)
    ids, y = r.randint(0, 30, (6, 4)), r.randint(0, 2, (6,))
    losses = []
    for _ in range(steps):
        loss = jnn.functional.cross_entropy(
            lin(emb(paddle.to_tensor(ids)).mean(axis=1)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return w0, losses, np.asarray(emb.weight._value), np.asarray(
        lin.weight._value)


def _train_port(w0, sparse, opt_cls, steps, **kw):
    emb = Embedding(30, 8, sparse=sparse, device="cpu")
    lin = torch.nn.Linear(8, 2)
    with torch.no_grad():
        emb.weight.copy_(torch.tensor(w0[0]))
        lin.weight.copy_(torch.tensor(w0[1].T))
        lin.bias.copy_(torch.tensor(w0[2]))
    opt = opt_cls(learning_rate=0.1,
                  parameters=list(emb.parameters()) + list(lin.parameters()),
                  **kw)
    r = np.random.RandomState(3)
    ids, y = r.randint(0, 30, (6, 4)), r.randint(0, 2, (6,))
    losses = []
    for _ in range(steps):
        loss = tF.cross_entropy(lin(emb(torch.tensor(ids)).mean(1)),
                                torch.tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses, emb.weight.detach().numpy(), lin.weight.detach().numpy().T


CASES = {  # name: (optimizer, kwargs)
    "sgd": ("SGD", {}),
    "sgd_decay": ("SGD", {"weight_decay": 0.01}),
    "adam_dense": ("Adam", {}),
    "adam_lazy": ("Adam", {"lazy_mode": True}),
    "adam_lazy_decay": ("Adam", {"lazy_mode": True, "weight_decay": 0.01}),
    "adamw_dense": ("AdamW", {}),
    "adamw_lazy": ("AdamW", {"lazy_mode": True}),
    "sgd_clip": ("SGD", {"clip": 0.05}),
    "adam_lazy_clip": ("Adam", {"lazy_mode": True, "clip": 0.05}),
    "adamw_clip": ("AdamW", {"clip": 0.05}),
}


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_jax(case, sparse):
    """5 steps of an embedding (sparse or dense gradient) and a Linear:
    losses and weights equal to the JAX package's; the clip's global norm
    counts sparse and dense gradients together and scales both."""
    name, kw = CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if "clip" in kw:
        jkw["grad_clip"] = paddle.nn.ClipGradByGlobalNorm(jkw.pop("clip"))
        tkw["grad_clip"] = ClipGradByGlobalNorm(tkw.pop("clip"))
    w0, jl, jw, jlw = _train_jax(sparse, getattr(paddle.optimizer, name), 5,
                                 **jkw)
    tl, tw, tlw = _train_port(w0, sparse, getattr(topt, name), 5, **tkw)
    _close(tl, jl)
    _close(tw, jw)
    _close(tlw, jlw)


def test_lazy_adam_touches_only_looked_up_rows():
    """lazy_mode: untouched rows keep their weights and zero moments; the
    f32 master of a bf16 weight (multi_precision) moves at the touched
    rows, and the weight is that master rounded there."""
    emb = Embedding(12, 4, sparse=True, dtype=torch.bfloat16, device="cpu",
                    generator=torch.Generator().manual_seed(2))
    w0 = emb.weight.detach().clone()
    opt = topt.Adam(0.05, parameters=emb.parameters(), lazy_mode=True,
                    multi_precision=True)
    ids = torch.tensor([[1, 5, 5]])
    for _ in range(3):
        emb(ids).float().square().sum().backward()
        opt.step()
        opt.clear_grad()
    st = opt.state_dict()
    touched = torch.zeros(12, dtype=torch.bool)
    touched[[1, 5]] = True
    assert torch.equal(emb.weight[~touched], w0[~touched])
    assert not emb.weight[touched].eq(w0[touched]).all()
    assert not st["param_0.moment1"][~touched].any()
    assert st["param_0.moment1"][touched].abs().gt(0).all()
    master = st["param_0.master_weight"]
    assert master.dtype == torch.float32
    assert torch.equal(master.to(torch.bfloat16), emb.weight.detach())


def test_loss_scaler_with_sparse_gradients_raises():
    emb = Embedding(6, 2, sparse=True, device="cpu")
    emb(torch.tensor([1])).sum().backward()
    opt = topt.Adam(parameters=emb.parameters())
    with pytest.raises(NotImplementedError, match="loss scaler"):
        opt.step(amp=object())
