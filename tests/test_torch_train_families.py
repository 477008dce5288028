"""Training and checkpoints of the MoE, enc-dec and vlm families on the
CPU: the round batches carry the stubbed ``enc`` frames / ``prefix``, the
training launcher runs every configuration's ``--smoke`` size, final
parameters of reduced seamless-m4t-medium and dbrx-132b cross between the
packages' checkpoint files both ways, and ``launch.train --ckpt`` then
``launch.serve --ckpt`` runs on an enc-dec model; xlstm-350m's training
route (the chunkwise mLSTM) gives the per-step form's gradient."""
from __future__ import annotations

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.core.engine import tree_from_items, tree_items
from repro_torch.data import TokenTask, make_lm_batch, make_round_batch
from repro_torch.models import build_model, params_from_numpy
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)


def test_round_batches_carry_frames_and_prefix():
    """An enc-dec batch carries ``enc`` (B, n_prefix, d_model) frames, a
    vlm batch its ``prefix``, fp32, 0.02 x normal draws from the batch's
    own generator (the same numbers for the same (seed, worker, step)),
    stacked (tau, M, B, ...) in a round batch."""
    for name, key in (("seamless-m4t-medium", "enc"),
                      ("internvl2-2b", "prefix"), ("dbrx-132b", None)):
        cfg = reduced(get_arch(name))
        task = TokenTask(vocab_size=cfg.vocab_size, seq_len=12)
        b = make_lm_batch(task, 0, 1, 2, 3, cfg, device="cpu")
        assert sorted(b) == sorted(["tokens", "labels"] + ([key] if key
                                                          else []))
        again = make_lm_batch(task, 0, 1, 2, 3, cfg, device="cpu")
        for k in b:
            assert torch.equal(b[k], again[k]), k
        if key:
            x = b[key]
            assert x.shape == (3, cfg.n_prefix, cfg.d_model)
            assert x.dtype == torch.float32
            assert 0.01 < float(x.std()) < 0.03
            assert not torch.equal(
                x, make_lm_batch(task, 0, 2, 2, 3, cfg, device="cpu")[key])
        rb = make_round_batch(task, 0, 2, 3, 0, 4, cfg, device="cpu")
        assert all(v.shape[:3] == (3, 2, 4) for v in rb.values())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_launcher_trains_every_arch_on_cpu(arch):
    """``launch.train --smoke`` of every configuration: two workers, two
    rounds of two local steps on the flat engine, a finite eval loss."""
    from repro_torch.launch.train import main
    loss = main(["--arch", arch, "--smoke", "--workers", "2", "--tau", "2",
                 "--steps", "4", "--seq", "8", "--batch", "2"],
                device="cpu")
    assert math.isfinite(loss)


@pytest.mark.parametrize("name", ["seamless-m4t-medium", "dbrx-132b"])
def test_final_params_cross_packages_both_ways(name, tmp_path):
    """Reduced seamless-m4t-medium (the enc-dec tree) and dbrx-132b (the
    MoE tree, its fp32 router): a final-params file the reference writes
    loads into the port's tree bit for bit, and the port's file of the
    same weights loads into the reference's."""
    jcfg, cfg = jreduced(jget_arch(name)), reduced(get_arch(name))
    jparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(4))
    ref_file = str(tmp_path / "ref.npz")
    jsave_pytree(ref_file, jparams, extra={"steps": 3})
    like = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    got, extra = load_pytree(ref_file, like)
    want = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    assert int(extra["steps"]) == 3
    for (pa, a), (pb, b) in zip(tree_items(got), tree_items(want)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    mine = str(tmp_path / "mine.npz")
    save_pytree(mine, want)
    back, _ = jload_pytree(mine, jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_then_serve_encdec_from_checkpoint(tmp_path):
    """``launch.train --smoke --arch seamless-m4t-medium --ckpt`` writes
    the final parameters; ``launch.serve --smoke --ckpt`` serves them
    (frames drawn per request), and its tokens differ from the random
    init's."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    arch = ["--arch", "seamless-m4t-medium", "--smoke"]
    ck = str(tmp_path / "s.npz")
    train_main(arch + ["--workers", "2", "--tau", "2", "--steps", "4",
                       "--seq", "8", "--batch", "2", "--lr", "0.5",
                       "--ckpt", ck], device="cpu")
    argv = arch + ["--requests", "3", "--max-slots", "2", "--prompt-len",
                   "8", "--new-tokens", "4", "--chunk", "4"]
    a = serve_main(argv + ["--ckpt", ck], device="cpu")
    b = serve_main(argv, device="cpu")
    toks = lambda r: [r.results[i].tokens for i in sorted(r.results)]
    assert sorted(a.results) == [0, 1, 2]
    assert toks(a) != toks(b)


def _loss_grads_and_saved_bytes(cfg, params, batch):
    """The loss, its gradient leaves, and the bytes autograd saved for the
    backward pass (counted as each tensor is packed)."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    leaves = [leaf.detach().requires_grad_(True)
              for _, leaf in tree_items(params)]
    tree = tree_from_items([(p, leaf) for (p, _), leaf in
                            zip(tree_items(params), leaves)])
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = build_model(cfg).loss(tree, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads, saved[0]


def test_xlstm_trains_on_the_chunkwise_mlstm():
    """``chip_smoke.py`` phase 17(d) trains xlstm-350m with
    ``xlstm_chunk = 16``: the published per-step mLSTM saves every step's
    (B, H, P, P) matrix memory for the backward pass (> 100 GB at full
    width, seq 64, batch 8). On the reduced config at seq 64 the chunkwise
    form gives the per-step form's loss and gradient and saves a fraction
    of its bytes."""
    base = reduced(get_arch("xlstm-350m"), n_layers=4)
    assert base.xlstm_chunk == 0
    params = build_model(base).init(torch.Generator().manual_seed(3), "cpu")
    task = TokenTask(vocab_size=base.vocab_size, seq_len=64)
    batch = make_lm_batch(task, 0, 0, 0, 2, base, device="cpu")
    step_loss, step_g, step_bytes = _loss_grads_and_saved_bytes(
        base, params, batch)
    chunk = dataclasses.replace(base, xlstm_chunk=16)
    loss, grads, nbytes = _loss_grads_and_saved_bytes(chunk, params, batch)
    assert loss == pytest.approx(step_loss, abs=1e-5)
    for g, sg in zip(grads, step_g):
        np.testing.assert_allclose(g.numpy(), sg.numpy(), rtol=1e-3,
                                   atol=1e-4)
    assert nbytes < step_bytes / 2, (nbytes, step_bytes)
