"""Rank programs of the port's mesh tests (``tests/test_torch_mesh.py``):
gloo process groups of CPU ranks spawned with ``torch.multiprocessing``
over a ``FileStore``.  This module imports no JAX: the spawned ranks import
it (not the test module) to find their program.

``spawn(program, world, workdir, *args, timeout)`` runs ``program(rank,
world, workdir, *args)`` in ``world`` ranks; each rank's stderr goes to
``workdir/rank<r>.log``; rank 0's return value comes back.  A rank that
raises, or a group that outlives ``timeout`` seconds, fails the call with
every rank's log tail, and no rank is left running.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("qwen3-14b-smoke", "deepseek-moe-16b-smoke")
# the hybrid, ssm, audio and vlm families (tests/test_torch_mesh_families.py)
FAMILY_ARCHS = ("recurrentgemma-9b-smoke", "xlstm-1.3b-smoke",
                "whisper-base-smoke", "llava-next-mistral-7b-smoke")
# the hybrid's ring: a prompt of 8, then 12 decode steps past the wrap of
# its 16-slot window (positions 8..19), split over the model axis
RING_ARCH, RING_PROMPT, RING_STEPS = "recurrentgemma-9b-smoke", 8, 12
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 32, 3
SERVE_B, SERVE_S, SERVE_N, SERVE_MAX = 8, 16, 3, 24
# (name, routing, microbatches, compress_grads)
VARIANTS = (("direct", "direct", 1, False),
            ("coordinator", "coordinator", 1, False),
            ("microbatches_2", "direct", 2, False),
            ("compress_grads", "direct", 1, True))


class RankFailure(AssertionError):
    pass


def _rank_main(rank, world, workdir, program, args, backend):
    log = open(Path(workdir) / f"rank{rank}.log", "w")
    os.dup2(log.fileno(), 2)
    sys.stderr = log
    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(workdir) / f"store_{program.__name__}"),
                           world)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        out = program(rank, world, workdir, *args)
        if rank == 0:
            torch.save(out, Path(workdir) / "result.pt")
    except BaseException:
        traceback.print_exc(file=log)
        log.flush()
        raise
    finally:
        dist.destroy_process_group()


def _tails(workdir, world, n=3000) -> str:
    out = []
    for r in range(world):
        p = Path(workdir) / f"rank{r}.log"
        text = p.read_text() if p.exists() else "(no log)"
        out.append(f"--- rank {r} ---\n{text[-n:]}")
    return "\n".join(out)


def spawn(program, world: int, workdir, *args, timeout: float = 300.0,
          backend: str = "gloo"):
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / f"store_{program.__name__}").unlink(missing_ok=True)
    (workdir / "result.pt").unlink(missing_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, str(workdir), program,
                                               args, backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise RankFailure(f"{program.__name__} on {world} ranks ran "
                                  f"past {timeout} s\n"
                                  + _tails(workdir, world))
    except mp.ProcessRaisedException as e:
        raise RankFailure(f"{program.__name__}: a rank raised\n{e}\n"
                          + _tails(workdir, world)) from None
    except mp.ProcessExitedException as e:
        raise RankFailure(f"{program.__name__}: a rank exited\n{e}\n"
                          + _tails(workdir, world)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return torch.load(workdir / "result.pt", weights_only=False)


# -- shared pieces -------------------------------------------------------------

def ref_params(ref, arch, cfg, tag="init"):
    """The reference's params of ``arch`` (leaves saved in ``leaves``
    order) as the port's params on the CPU."""
    from repro_torch.models import lm
    from repro_torch.nn.layers import leaves, unflatten
    template = lm.abstract_model(cfg)
    flat = [torch.from_numpy(np.array(ref[f"{arch}/{tag}/{i}"]))
            for i in range(len(leaves(template)))]
    return unflatten(template, flat)


def _full(tree):
    from repro_torch.nn.layers import map_defs
    from repro_torch.parallel.sharding import is_dtensor
    return map_defs(lambda t: (t.full_tensor() if is_dtensor(t) else t)
                    .detach().clone(), tree)


def frontend_stub(cfg, b: int, rng) -> dict:
    """The stub frontend's input of an audio (``frames``) or vlm
    (``patches``) config, float32 from ``rng``; {} for the others."""
    stub = {"audio": ("frames", cfg.n_audio_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub is None:
        return {}
    return {stub[0]: rng.standard_normal((b, stub[1], cfg.d_model)).astype(
        np.float32)}


def train_batch(cfg, step: int) -> dict:
    """SyntheticLM's batch ``step`` (TRAIN_BATCH x TRAIN_SEQ) and its
    frontend stub."""
    from repro_torch.data.pipeline import SyntheticLM
    batch = SyntheticLM(cfg.vocab_size, seed=0).batch(step, TRAIN_BATCH,
                                                      TRAIN_SEQ)
    return {**batch, **frontend_stub(cfg, TRAIN_BATCH,
                                     np.random.default_rng(100 + step))}


def _ocfg():
    from repro_torch.train.optimizer import OptConfig
    return OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)


def _train(cfg, params, steps, *, mesh=None, start=0, state=None,
           grads=None, device="cpu", **opts):
    """``steps`` train steps from ``params`` (or a state) over SyntheticLM
    batches ``start``..; returns (losses, params, opt state).  A list
    ``grads`` (one device only) receives each element's smallest gradient
    magnitude over the steps, a tensor a leaf."""
    from repro_torch.parallel.sharding import shard_tree, param_shardings
    from repro_torch.models import lm
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import TrainOptions, make_train_step
    options = TrainOptions(donate=False, **opts)
    step = make_train_step(cfg, _ocfg(), options, mesh=mesh,
                           device=None if mesh is not None else device)
    if state is None:
        if mesh is not None:
            params = shard_tree(params, param_shardings(
                lm.model_spec_tree(cfg), step.rules, shapes=params))
        state = (params, init_opt_state(params))
    p, o = state
    losses = []
    for i in range(start, start + steps):
        batch = train_batch(cfg, i)
        if grads is not None:
            from repro_torch.nn.layers import leaves
            from repro_torch.train.trainer import loss_and_grads, to_device
            g = [t.abs() for t in leaves(loss_and_grads(
                p, to_device(batch, device), cfg, options.microbatches)[1])]
            grads[:] = g if not grads else [torch.minimum(a, b)
                                            for a, b in zip(grads, g)]
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    return losses, p, o


def _serve(cfg, params, prompt, dec, *, mesh=None, device="cpu",
           states=None):
    """Prefill of ``prompt`` (a dict of host arrays) + len(dec) decode
    steps; the logits of each, and the local slot count of the first
    self-attention cache (None where the model has none).  A dict
    ``states`` receives the final recurrent states' local shards
    (``recurrent_states``)."""
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import local, shard_tree
    from repro_torch.train import serve
    b = len(prompt["tokens"])
    kw = dict(mesh=mesh) if mesh is not None else dict(device=device)
    pre = serve.make_prefill_step(cfg, b, SERVE_MAX, **kw)
    de = serve.make_decode_step(cfg, b, SERVE_MAX, **kw)
    if mesh is None:
        cache = lm.init_cache(cfg, b, SERVE_MAX, device=device)
    else:
        _, p_sh = serve.abstract_serve_params(cfg, pre.rules)
        params = shard_tree(params, p_sh)
        cache = serve.place_cache(cfg, pre.rules, b, SERVE_MAX)
    full = (lambda t: t.full_tensor()) if mesh is not None else (lambda t: t)
    dev = next(iter(leaves_of(params))).device
    lg, cache = pre(params, cache, {k: torch.from_numpy(v).to(dev)
                                    for k, v in prompt.items()})
    out = [full(lg).cpu()]
    for t in range(len(dec)):
        lg, cache = de(params, cache, torch.from_numpy(dec[t]).to(dev))
        out.append(full(lg).cpu())
    attn = [c for stack in cache["stacks"] for blk in stack.values()
            if (c := lm._self_cache(blk)) is not None]
    if states is not None:
        states.update(recurrent_states(cache))
    return torch.stack(out), (int(local(attn[0]["k"]).shape[2]) if attn
                              else None)


def recurrent_states(cache) -> dict:
    """{(stack, block key, leaf): this rank's local shard} of every
    recurrent block's state in ``cache``, copied."""
    from repro_torch.parallel.sharding import local
    return {(si, key, leaf): local(t).detach().clone()
            for si, stack in enumerate(cache["stacks"])
            for key, blk in stack.items()
            if key.split("_", 1)[1] in ("rec", "mlstm", "slstm")
            for leaf, t in blk.items()}


def leaves_of(tree):
    from repro_torch.nn.layers import leaves
    return leaves(tree)


def serve_inputs(cfg, s: int = SERVE_S, n: int = SERVE_N):
    """({'tokens': (SERVE_B, s)} and the frontend stub, decode tokens
    (n, SERVE_B, 1)), host arrays from a seed."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (SERVE_B, s)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab_size, (n, SERVE_B, 1)).astype(np.int32)
    return {"tokens": prompt, **frontend_stub(cfg, SERVE_B, rng)}, dec


@contextlib.contextmanager
def probe():
    """What this rank computes while the block runs: each call of the
    experts' FFN as (its capacity buffer's shape (G, E, C, d), ``wi``'s
    shape (E, d, ff)) under ``"experts"``; each train or prefill
    attention as (its queries, its keys and values, causal) under
    ``"attn"``; each attention projection as (its positions, the weight's
    shape (d, *heads)) under ``"proj"``; the mesh's embedding lookup, LM
    head and loss log-sum-exp as ("embed", its table's shape), ("head",
    the head's shape (d, V)) and ("loss", (its logit columns,)) under
    ``"vocab"``; under ``"recurrent"`` each recurrent block's kept weights'
    shapes and the shapes of the state leaves it read (() in train):
    ("rec", w_x, w_gate, w_out, (h, conv)), ("mlstm", w_up, its v's
    last dim, (C, n, m, conv)), ("slstm", up, down).  Its lists hold
    tuples of ints and tuples only, so that a set of them sorts."""
    from repro_torch.models import lm
    from repro_torch.nn import moe
    rec: dict = {"experts": [], "attn": [], "proj": [], "vocab": [],
                 "recurrent": []}
    saved = (moe._expert_ffn, lm.gqa_attention, lm._project,
             lm._vocab_embed, lm._lm_head, lm._split_logz, lm.rglru_block,
             lm._apply_mlstm, lm.mlstm_sequence, lm.mlstm_step,
             lm._apply_slstm)
    (ffn, attn, project, embed, head, logz, rglru, mlstm, mlstm_seq,
     mlstm_step, slstm) = saved

    def shapes(tree, names):
        return tuple(tuple(tree[k].shape) for k in names) \
            if tree is not None else ()

    def rglru_probe(p, x, cfg, cache=None, split=None):
        rec["recurrent"].append(("rec", *shapes(p, ("w_x", "w_gate",
                                                     "w_out")),
                                 shapes(cache, ("h", "conv"))))
        return rglru(p, x, cfg, cache=cache, split=split)

    v_dim: list = []

    def seq_probe(q, k, v, *a, **kw):
        v_dim.append(v.shape[-1])
        return mlstm_seq(q, k, v, *a, **kw)

    def step_probe(q, k, v, *a, **kw):
        v_dim.append(v.shape[-1])
        return mlstm_step(q, k, v, *a, **kw)

    def mlstm_probe(cell, xn, ctx, cache):
        out = mlstm(cell, xn, ctx, cache)
        rec["recurrent"].append(("mlstm", tuple(cell["w_up"].shape),
                                 v_dim.pop(),
                                 shapes(cache, ("C", "n", "m", "conv"))))
        return out

    def slstm_probe(cell, xn, ctx, cache):
        rec["recurrent"].append(("slstm", *shapes(cell, ("up", "down"))))
        return slstm(cell, xn, ctx, cache)

    def ffn_probe(p, x):
        rec["experts"].append((tuple(x.shape), tuple(p["wi"].shape)))
        return ffn(p, x)

    def attn_probe(q, k, v, **kw):
        rec["attn"].append((q.shape[1], k.shape[1], kw.get("causal", True)))
        return attn(q, k, v, **kw)

    def project_probe(x, w):
        rec["proj"].append((x.shape[1], tuple(w.shape)))
        return project(x, w)

    def embed_probe(table, tokens, v0):
        rec["vocab"].append(("embed", tuple(table.shape)))
        return embed(table, tokens, v0)

    def head_probe(x, w):
        rec["vocab"].append(("head", tuple(w.shape)))
        return head(x, w)

    def logz_probe(lg, group):
        rec["vocab"].append(("loss", (lg.shape[-1],)))
        return logz(lg, group)

    (moe._expert_ffn, lm.gqa_attention, lm._project, lm._vocab_embed,
     lm._lm_head, lm._split_logz, lm.rglru_block, lm._apply_mlstm,
     lm.mlstm_sequence, lm.mlstm_step, lm._apply_slstm) = (
        ffn_probe, attn_probe, project_probe, embed_probe, head_probe,
        logz_probe, rglru_probe, mlstm_probe, seq_probe, step_probe,
        slstm_probe)
    try:
        yield rec
    finally:
        (moe._expert_ffn, lm.gqa_attention, lm._project, lm._vocab_embed,
         lm._lm_head, lm._split_logz, lm.rglru_block, lm._apply_mlstm,
         lm.mlstm_sequence, lm.mlstm_step, lm._apply_slstm) = saved


def recurrent_want(cfg, m: int, rows: int | None) -> list:
    """The ``probe`` "recurrent" records of a rank on a model axis of ``m``
    (each once): the RG-LRU's w_x, w_gate and w_out at d_rnn / m, the
    mLSTM's w_up at di / m and its v at dv / m, the sLSTM's up and down at
    dff / m; with ``rows`` (serve: the rank's batch rows) the state leaves
    read, each its local shard (channels / m, n and m and the sLSTM's
    whole); none for the other families."""
    from repro_torch.nn.recurrent import slstm_defs
    d = cfg.d_model
    if cfg.family == "hybrid":
        dr = (cfg.d_rnn or d) // m
        state = ((rows, dr), (rows, cfg.conv_width - 1, dr)) if rows else ()
        return [("rec", (d, dr), (d, dr), (dr, d), state)]
    if cfg.family != "ssm":
        return []
    di = int(cfg.proj_factor * d)
    hh = cfg.n_heads
    dk = di // hh
    state = ((rows, hh, dk, dk // m), (rows, hh, dk), (rows, hh),
             (rows, 3, di // m)) if rows else ()
    dff = slstm_defs(cfg)["up"].shape[-1] // m
    return sorted([("mlstm", (d, di // m), dk // m, state),
                   ("slstm", (d, dff), (dff, d))])


def decode_proj(rec) -> list:
    """The weight shapes of a ``probe`` record's projections of one
    position (decode's), each once."""
    return sorted({w for s, w in rec["proj"] if s == 1})


def decode_proj_want(cfg, m: int) -> list:
    """The weight shapes of decode's q, k and v projections on a rank of a
    model axis of ``m`` that splits the heads: K / m kv heads (or, under
    MQA, q's G / m groups, k and v whole); none for a model without
    attention (the ssm family)."""
    if cfg.family == "ssm":
        return []
    d, k, hd = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // k
    if k == 1:
        return sorted({(d, 1, g // m, hd), (d, 1, hd)})
    return sorted({(d, k // m, g, hd), (d, k // m, hd)})


def vocab_calls(cfg, m: int, train: bool) -> list:
    """Each rank's ``probe`` "vocab" records on a model axis of ``m``: the
    embedding's padded_vocab / m rows, the head's as many columns, and in
    train the loss's log-sum-exp over as many logit columns."""
    v, d = cfg.padded_vocab // m, cfg.d_model
    calls = [("embed", (v, d)), ("head", (d, v))]
    return sorted(calls + [("loss", (v,))] * train)


def every_rank(rec) -> list:
    """``rec`` of every rank of the default group, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


def _split_records(train, serve) -> dict:
    """Every rank's ``probe`` records of a mesh train run and serve run,
    each kind's calls as a set."""
    return {mode: [{k: sorted(set(v)) for k, v in r.items()}
                   for r in every_rank(rec)]
            for mode, rec in (("train", train), ("serve", serve))}


# a vocabulary that is not a multiple of 128: padded to 256, its 6 padded
# columns fall in the last model rank's slice on a model axis of 2
PADDED_VOCAB = 250


def padded_vocab_loss(mesh, single: bool, tie: bool = False) -> dict:
    """``lm.lm_loss`` and its gradients (``trainer.loss_and_grads``) of
    ARCHS[0] with ``vocab_size`` PADDED_VOCAB (and ``tie_embeddings`` if
    ``tie``: the head is the table's slice transposed), at seed-0 params,
    over SyntheticLM's batch 0 (a loss mask from a seed zeroing some
    targets): on ``mesh`` under its train rules and, if ``single``, on one
    device; each (loss, whole gradients)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import (param_shardings, shard_tree,
                                               use_rules)
    from repro_torch.train.trainer import (loss_and_grads, to_device,
                                           train_rules)
    cfg = dataclasses.replace(get_config(ARCHS[0]), vocab_size=PADDED_VOCAB,
                              tie_embeddings=tie)
    params = lm.init_model(cfg, 0, device="cpu")
    batch = dict(train_batch(cfg, 0), loss_mask=(np.random.default_rng(
        9).random((TRAIN_BATCH, TRAIN_SEQ)) > 0.2).astype(np.float32))
    batch = to_device(batch, "cpu")
    rules = train_rules(mesh)
    placed = shard_tree(params, param_shardings(
        lm.model_spec_tree(cfg), rules, shapes=params))
    with use_rules(rules):
        loss, grads = loss_and_grads(placed, batch, cfg)
    out = dict(mesh=(float(loss), _full(grads)), padded=cfg.padded_vocab)
    if single:
        loss, grads = loss_and_grads(params, batch, cfg)
        out["single"] = (float(loss), _full(grads))
    return out


# -- programs ------------------------------------------------------------------

def mesh_suite(rank, world, workdir, ref_path):
    """World 8: the sharded train step (every variant, both configs) and
    the serve steps on (2,2,2); the loss of a padded vocabulary
    (``padded_vocab_loss``, the head its own or tied) on (2,2,2); the lse
    merge at model 2 and 4; a
    checkpoint saved on (4,2) and restored onto (2,4); compressed_psum;
    2 steps on (4,2) saved for the elastic restart."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import Sharding, make_rules
    ref = dict(np.load(ref_path))
    out: dict = {"train": {}, "serve": {}}
    m222 = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    t0 = time.perf_counter()
    for arch in ARCHS:
        cfg = get_config(arch)
        init = ref_params(ref, arch, cfg)
        for name, routing, micro, comp in VARIANTS:
            opts = dict(microbatches=micro, compress_grads=comp)
            gmin: list = []
            single = _train(cfg, init, TRAIN_STEPS, grads=gmin, **opts) \
                if rank == 0 else None
            with probe() as rec:
                losses, p, _ = _train(cfg, init, TRAIN_STEPS, mesh=m222,
                                      routing=routing, **opts)
            if name == "direct":
                train_rec = rec
                # a port checkpoint written on the mesh, for the reference
                save_checkpoint(str(Path(workdir) / f"ckpt_{arch}"),
                                TRAIN_STEPS, {"params": p})
            p = _full(p)
            if rank == 0:
                out["train"][(arch, name)] = dict(
                    mesh=losses, single=single[0], params=p,
                    single_params=single[1], grad_min=gmin, lr=_ocfg().lr)
        prompt, dec = serve_inputs(cfg)
        single = _serve(cfg, init, prompt, dec) if rank == 0 else None
        with probe() as rec:
            got, slots = _serve(cfg, init, prompt, dec, mesh=m222)
        splits = _split_records(train_rec, rec)
        if rank == 0:
            out["serve"][(arch, "222")] = dict(mesh=got, single=single[0],
                                               local_slots=slots)
            out.setdefault("splits", {})[arch] = splits
    out["seconds_train_serve"] = time.perf_counter() - t0
    out["padded_vocab"] = {tie: padded_vocab_loss(m222, rank == 0, tie)
                           for tie in (False, True)}
    out["lse"] = {n: lse_merge(make_mesh(shape, ("data", "model"),
                                         device="cpu"))
                  for n, shape in ((2, (4, 2)), (4, (2, 4)))}
    # checkpoint reshard: (4,2) -> (2,4)
    from torch.distributed.tensor import Shard
    m42 = make_mesh((4, 2), ("data", "model"), device="cpu")
    m24 = make_mesh((2, 4), ("data", "model"), device="cpu")
    x = torch.arange(64.0).reshape(8, 8)
    r42, r24 = make_rules(m42), make_rules(m24)
    spec = ("batch", "ff")
    xs = Sharding(m42, r42.fit_spec(spec, x.shape),
                  r42.placements(spec, x.shape))
    from repro_torch.parallel.sharding import shard_tensor
    ck = str(Path(workdir) / "reshard")
    save_checkpoint(ck, 1, {"x": shard_tensor(x, xs)})
    back = restore_checkpoint(ck, 1, {"x": x}, shardings={"x": Sharding(
        m24, r24.fit_spec(spec, x.shape), r24.placements(spec, x.shape))})[
            "x"]
    out["reshard"] = dict(full=back.full_tensor(), local=back.to_local(),
                          placements=tuple(back.placements),
                          model=m24.size(1), want_local=(4, 2))
    assert back.placements == (Shard(0), Shard(1))
    # compressed psum over 8 ranks of the same tensor
    from repro_torch.parallel.collectives import make_compressed_grad_sync
    m8 = make_mesh((8,), ("data",), device="cpu")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 16)).astype(np.float32))
    out["psum"] = dict(g=g, out=make_compressed_grad_sync(m8, "data", 8)(
        {"w": g})["w"])
    # elastic, first half: 2 steps on (4,2), saved
    cfg = get_config(ARCHS[0])
    losses, p, o = _train(cfg, ref_params(ref, ARCHS[0], cfg), 2, mesh=m42)
    save_checkpoint(str(Path(workdir) / "elastic"), 2,
                    {"params": p, "opt": o})
    out["elastic_first"] = losses
    return out


def lse_merge(mesh):
    """The plain decode_attn on each rank's slice of a cache split along S
    over the model axis, merged by ``lm._decode_kv_shard``, against the
    unsharded plain version, at positions whose length ends on a slice
    boundary (the last rank holds no valid slot), inside a slice, and on
    the first slot (every rank but the first empty)."""
    from repro_torch.kernels.decode_attn.ops import flash_decode_ref
    from repro_torch.models import lm
    n = mesh.size(1)
    r = mesh.get_local_rank(1)
    w_loc = 8
    b, s, k, g, hd = 6, w_loc * n, 2, 3, 16
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((b, 1, k, g, hd)).astype(
        np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((b, s, k, hd)).astype(
        np.float32)) for _ in range(2))
    out = []
    for pos in (w_loc * (n - 1) - 1, w_loc + 3, 0):
        exp = flash_decode_ref(q, ck, cv, torch.full((b,), pos + 1,
                                                     dtype=torch.int32))
        cache = {"k": ck[:, r * w_loc:(r + 1) * w_loc].clone(),
                 "v": cv[:, r * w_loc:(r + 1) * w_loc].clone(),
                 "kv_pos": torch.full((w_loc,), -1, dtype=torch.int32)}
        mc = lm.MeshCtx(rules=None, mesh=mesh, batch=b, rows=(),
                        row_range=(0, b), grad=(),
                        kv=(mesh.get_group(1), n, r))
        ctx = lm.Ctx(cfg=None, mode="decode", positions=torch.full(
            (b, 1), pos, dtype=torch.int32), pos=pos, mesh=mc)
        # the new token's k and v are the ones the cache holds at pos
        got = lm._decode_kv_shard(q, ck[:, pos:pos + 1], cv[:, pos:pos + 1],
                                  cache, ctx)
        out.append(dict(got=got, exp=exp, pos=pos, slots=s, empty_ranks=[
            i for i in range(n) if i * w_loc >= pos + 1]))
    return out


def elastic_second(rank, world, workdir, ref_path):
    """World 4: the state saved on (4,2) after 2 steps restored onto (2,2),
    2 more steps; rank 0 also runs 4 single-device steps."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import (TrainOptions, abstract_train_state,
                                           state_shardings, train_rules)
    ref = dict(np.load(ref_path))
    cfg = get_config(ARCHS[0])
    init = ref_params(ref, ARCHS[0], cfg)
    m22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = train_rules(m22, TrainOptions())
    p_abs, o_abs = abstract_train_state(cfg, rules)
    template = {"params": lm.abstract_model(cfg),
                "opt": init_opt_state(lm.abstract_model(cfg))}
    st = restore_checkpoint(str(Path(workdir) / "elastic"), 2, template,
                            shardings={"params": state_shardings(p_abs),
                                       "opt": state_shardings(o_abs)})
    losses, _, _ = _train(cfg, None, 2, mesh=m22, start=2,
                          state=(st["params"], st["opt"]))
    single = _train(cfg, init, 4)[0] if rank == 0 else None
    return dict(second=losses, single=single,
                step=int(st["opt"]["step"]))


def serve_12(rank, world, workdir, ref_path):
    """World 2: the serve steps on (1,2) ("data", "model"), of SERVE_S
    prompt tokens and of SERVE_S - 1 (``"12_odd"``: the model axis splits
    prefill's positions unevenly, 8 and 7); rank 0's ``probe`` records of
    each."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    ref = dict(np.load(ref_path))
    m12 = make_mesh((1, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        init = ref_params(ref, arch, cfg)
        for name, s in (("12", SERVE_S), ("12_odd", SERVE_S - 1)):
            prompt, dec = serve_inputs(cfg, s)
            single = _serve(cfg, init, prompt, dec) if rank == 0 else None
            with probe() as rec:
                got, slots = _serve(cfg, init, prompt, dec, mesh=m12)
            out[(arch, name)] = dict(mesh=got, single=None if single is None
                                     else single[0], local_slots=slots,
                                     probe=rec)
    return out


def _local_state_shapes(cfg, mesh) -> dict:
    """{block key: {leaf: local shape}} of the first stack of a cache
    placed by the serve rules on ``mesh`` (SERVE_B x SERVE_MAX)."""
    from repro_torch.train import serve
    cache = serve.place_cache(cfg, serve.serve_rules(mesh), SERVE_B,
                              SERVE_MAX)

    def shapes(blk):
        return {k: shapes(v) if isinstance(v, dict) else
                tuple(v.to_local().shape) for k, v in blk.items()}

    return shapes(cache["stacks"][0])


def _family_serves(cfg, arch, init, mesh, name, rank) -> dict:
    """The serve steps of ``arch`` on ``mesh`` (and on one device, rank 0),
    and for the hybrid the ring past its wrap, keyed (arch, name) and
    (arch, name + "_ring"); each with this rank's ``probe`` records of the
    mesh's steps."""
    out = {}
    cases = [("", SERVE_S, SERVE_N)]
    if arch == RING_ARCH:
        cases.append(("_ring", RING_PROMPT, RING_STEPS))
    for tag, s, n in cases:
        prompt, dec = serve_inputs(cfg, s, n)
        states = {"single": {}, "mesh": {}}
        single = _serve(cfg, init, prompt, dec, states=states["single"])[0] \
            if rank == 0 else None
        with probe() as rec:
            got, slots = _serve(cfg, init, prompt, dec, mesh=mesh,
                                states=states["mesh"])
        out[(arch, name + tag)] = dict(mesh=got, single=single,
                                       local_slots=slots, probe=rec)
        if not tag:
            # every rank's final recurrent states, beside one device's
            out[(arch, name)]["states"] = dict(
                single=states["single"], mesh=every_rank(states["mesh"]))
    out[(arch, name)]["local_state"] = _local_state_shapes(cfg, mesh)
    return out


def family_suite(rank, world, workdir, ref_path):
    """World 8, mesh (2,2,2): for each of FAMILY_ARCHS the sharded train
    step (TRAIN_STEPS, direct routing) against one device, saved as a
    checkpoint for the reference; the serve steps, and the hybrid's ring
    past its wrap, against one device."""
    from repro_torch.ckpt.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    ref = dict(np.load(ref_path))
    out: dict = {"train": {}, "serve": {}}
    m222 = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    t0 = time.perf_counter()
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        init = ref_params(ref, arch, cfg)
        gmin: list = []
        single = _train(cfg, init, TRAIN_STEPS, grads=gmin) \
            if rank == 0 else None
        with probe() as train_rec:
            losses, p, _ = _train(cfg, init, TRAIN_STEPS, mesh=m222)
        save_checkpoint(str(Path(workdir) / f"ckpt_{arch}"), TRAIN_STEPS,
                        {"params": p})
        p = _full(p)
        if rank == 0:
            out["train"][arch] = dict(
                mesh=losses, single=single[0], params=p,
                single_params=single[1], grad_min=gmin, lr=_ocfg().lr)
        serves = _family_serves(cfg, arch, init, m222, "222", rank)
        splits = _split_records(train_rec, serves[(arch, "222")]["probe"])
        out["serve"].update(serves)
        if rank == 0:
            out.setdefault("splits", {})[arch] = splits
    out["seconds"] = time.perf_counter() - t0
    return out


# the recurrent families, whose (1,2) serves record their final states
# and which take one train step on (1,2) too
RECURRENT_ARCHS = FAMILY_ARCHS[:2]


def family_serve_12(rank, world, workdir, ref_path):
    """World 2: the serve steps of FAMILY_ARCHS on (1,2) ("data",
    "model"), and the hybrid's ring past its wrap; one train step of
    RECURRENT_ARCHS on (1,2) (``"12_train"``: its losses, one device's,
    rank 0's ``probe`` records)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    ref = dict(np.load(ref_path))
    m12 = make_mesh((1, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        init = ref_params(ref, arch, cfg)
        out.update(_family_serves(cfg, arch, init, m12, "12", rank))
        if arch in RECURRENT_ARCHS:
            single = _train(cfg, init, 1)[0] if rank == 0 else None
            with probe() as rec:
                losses = _train(cfg, init, 1, mesh=m12)[0]
            out[(arch, "12_train")] = dict(mesh=losses, single=single,
                                           probe=rec)
    return out


def card_check(rank, world, workdir):
    """NCCL, one rank a card: mesh (world // 2, 2) ("data", "model") (or
    (world, 1) for an odd world), float32 with TF32 off: 2 train steps and
    the serve steps of each -smoke config against one card's."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import _full_fp32
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.nn.layers import map_defs
    shape = (world // 2, 2) if world % 2 == 0 else (world, 1)
    mesh = make_mesh(shape, ("data", "model"))
    dev = torch.device("cuda", rank)
    out = {}
    with _full_fp32():
        for arch in ARCHS:
            cfg = get_config(arch)
            init = lm.init_model(cfg, 0, device="cpu")
            on = map_defs(lambda t: t.to(dev), init)
            single = _train(cfg, on, 2, device=dev) if rank == 0 else None
            got = _train(cfg, on, 2, mesh=mesh)
            prompt, dec = serve_inputs(cfg)
            s_single = _serve(cfg, on, prompt, dec, device=dev) \
                if rank == 0 else None
            s_mesh = _serve(cfg, on, prompt, dec, mesh=mesh)
            if rank == 0:
                out[arch] = dict(losses=got[0], single=single[0],
                                 params=map_defs(lambda t: t.cpu(),
                                                 _full(got[1])),
                                 single_params=map_defs(lambda t: t.cpu(),
                                                        single[1]),
                                 logits=s_mesh[0], single_logits=s_single[0])
    out["shape"] = shape
    return out
