"""Jobs that ``torch_mesh_workers.run_world`` runs on each gloo rank: the
port's mesh layer on CPU ranks. Each returns plain tensors / numbers; the
tests compare them with the one-rank port and the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from torch_mesh_workers import rng_array

SIZES = (4, 6, 5, 7, 3, 6)


def survival_batch(b: int, m: int, wsi_dim: int, seed: int, n_real=None, empty_row=False):
    """A survival batch of numpy arrays, made from ``seed``."""
    rng = np.random.default_rng(seed)
    n_real = b if n_real is None else n_real
    mask = np.zeros((b, m), bool)
    for i in range(b):
        mask[i, :rng.integers(m // 3, m + 1)] = True
    if empty_row:
        mask[0, m // 2:] = False
    return {
        "wsi": rng_array(seed + 1, (b, m, wsi_dim)),
        "mask": mask,
        "omics_packed": rng_array(seed + 2, (b, sum(SIZES))),
        "label": rng.integers(0, 4, b).astype(np.int64),
        "censorship": rng.integers(0, 2, b).astype(np.float32),
        "survival_months": rng.uniform(1, 100, b).astype(np.float32),
        "weight": (np.arange(b) < n_real).astype(np.float32),
    }


def local_batch(batch, mesh):
    from multimodal_path_omic_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(batch, mesh, process_local=False)


def train_steps(name: str, data: int, seq: int, steps: int, dropout: float, seed: int,
                b: int, m: int, loss: str = "cesar", patch_dropout: float = 0.0,
                model_size: str = "small", wsi_dim: int = 64, params=None):
    """``steps`` train steps of a fresh model (``params``: a JAX parameter
    tree of numpy arrays to start from) on this rank's slices of the same
    global batches; returns losses, the gradients after step 1 and the
    parameters after the last step."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.parallel.mesh import make_mesh
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_train_step
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    mesh = make_mesh(data, seq, device="cpu") if data * seq > 1 else None
    ge = name.lower().startswith("ge")
    model = build_model(name, omic_sizes=SIZES, model_size=model_size, dropout=dropout,
                        wsi_dim=wsi_dim, mesh=mesh)
    if params is not None:
        from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params

        load_jax_params(model, params)
    else:
        seeded_init_(model, seed)
    opt = make_optimizer("adam", 1e-3)
    state = init_train_state(model, opt, seed)
    step = make_train_step(model, "ce" if ge else loss, opt, ge_mode=ge, omic_sizes=SIZES,
                           patch_budget=None, patch_dropout=patch_dropout, mesh=mesh)
    out = {"loss": [], "risk": []}
    for i in range(steps):
        batch = survival_batch(b, m, wsi_dim, seed + 10 * i, n_real=b - (i % 2))
        if ge:
            batch = {k: batch[k] for k in ("wsi", "mask", "label", "weight")}
            batch["label"] = batch["label"] % 3
        dev = local_batch(batch, mesh) if mesh is not None else {
            k: torch.from_numpy(v) for k, v in batch.items()}
        state, met = step(state, dev)
        out["loss"].append(float(met.loss))
        out["risk"].append(met.risk.clone())
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    out["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    return out


def cohort_config(root: str, name: str = "NaCAGaT", n_patients: int = 32, **sets):
    """The config dict of a small synthetic cohort under ``root`` (written
    once), on the CPU; ``sets``: dotted keys."""
    import os

    from multimodal_path_omic_tpu_torch.data.synthetic import (
        make_synthetic_cohort,
        synthetic_config_dict,
    )

    paths = (os.path.join(root, "cohort.csv"), os.path.join(root, "signatures.csv"),
             os.path.join(root, "patches"))
    if not os.path.exists(paths[0]):
        paths = make_synthetic_cohort(root, n_patients=n_patients, bag_lengths=(40, 90, 120),
                                      n_genes=24, n_signatures=4, embedding_dim=64, seed=0,
                                      signal_strength=2.0)
    raw = synthetic_config_dict(*paths)
    raw["device"] = "cpu"
    raw["model"].update(name=name, model_size="small", dropout=0.25,
                        checkpoint_dir=os.path.join(root, "ck"), checkpoint_epoch=0)
    raw["training"]["test_output_dir"] = None
    raw["training"].update(loss="ce" if name.lower().startswith("ge") else "cesar", epochs=2,
                           lr=1e-3, optimizer="adam", seed=0)
    raw["tpu"] = {"bag_buckets": [64, 128], "batch_size": 4, "device_cache": "off",
                  "steps_per_dispatch": 1}
    if name.lower().startswith("ge"):
        raw["model"]["gene"] = "G000"
    for key, value in sets.items():
        section, leaf = key.split(".")
        raw[section][leaf] = value
    return raw


def trainer_fit(root: str, name: str, sets: dict, predict: bool = False):
    """``Trainer.fit`` on this rank (the mesh from the config's axes); the
    fit's numbers, the final parameters, the best checkpoint's parameters
    and, with ``predict``, ``predict_dataset`` / ``predict_bags`` /
    ``evaluate`` of the trained model."""
    import torch

    from multimodal_path_omic_tpu_torch.config import config_from_dict
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    cfg = config_from_dict(cohort_config(root, name, **sets))
    t = Trainer(cfg, verbose=False, device="cpu")
    out = {"fit": t.fit(), "params": {k: p.detach().clone()
                                      for k, p in t.model.named_parameters()}}
    cache = t.device_cache
    out["cache"] = None if cache is None else {  # the train and validation caches
        "buckets": list(cache.cached_buckets), "partial": t._cache_partial,
        "wsi_bytes": sum(c["wsi"].nbytes for part in (cache, t.device_cache_val) if part
                         for c in part.caches.values())}
    if predict:
        p = Predictor.from_trainer(t)
        out["dataset"] = p.predict_dataset()
        ds = t.val_ds
        bags = [np.asarray(ds.bag(i)) for i in range(min(len(ds), 5))]
        omics = None if t.ge_mode else [
            [ds.table.signature_data[n][i] for n in ds.table.signature_names]
            for i in range(len(bags))]
        out["bags"] = p.predict_bags(bags, omics)
        out["bag"] = p.predict_bag(bags[0], None if omics is None else omics[0])
        from multimodal_path_omic_tpu_torch.train.analysis import evaluate

        out["evaluate"] = evaluate(cfg, trainer=t, verbose=False)
    if cfg.training.keep_best:
        import glob

        best = glob.glob(f"{cfg.model.checkpoint_dir}/*best*.pt")
        out["best"] = torch.load(best[0], weights_only=False)["model"] if best else None
    return out


# ------------------------------------------------------ test_torch_port_parallel


def attn_inputs(seed: int, b: int, h: int, n: int, m: int, d: int, seq: int):
    """q [B, H, N, D], k, v [B, H, M, D] and a [B, M] mask in which bag 0
    has no valid key in seq shard 0 and bag 1 none at all."""
    q = rng_array(seed, (b, h, n, d))
    k = rng_array(seed + 1, (b, h, m, d))
    v = rng_array(seed + 2, (b, h, m, d))
    mask = np.random.default_rng(seed + 3).random((b, m)) > 0.3
    mask[0, :m // seq] = False
    if b > 1:
        mask[1] = False
    return q, k, v, mask


def _rows_patches(x, mesh, row_axis=0, patch_axis=None):
    idx = [slice(None)] * x.ndim
    idx[row_axis] = mesh.rows(x.shape[row_axis])
    if patch_axis is not None:
        idx[patch_axis] = mesh.patches(x.shape[patch_axis])
    return x[tuple(idx)]


def _leaf(t, grad=True):
    return torch.from_numpy(np.ascontiguousarray(t)).requires_grad_(grad)


def _comm_case(mesh):
    from multimodal_path_omic_tpu_torch.parallel import comm

    r = mesh.rank
    out = {}
    for name, fn in (("sum", lambda x: comm.sum_over(x, mesh.world)),
                     ("gather", lambda x: comm.gather_over(x, mesh.world, 1))):
        x = _leaf(rng_array(100 + r, (3, 4)))
        y = torch.from_numpy(rng_array(200 + r, tuple(fn(x.detach()).shape)))
        res = fn(x)
        (res * y).sum().backward()
        out[name] = (res.detach(), x.grad.clone())
    x = torch.from_numpy(rng_array(300 + r, (5,)))
    out["max"] = comm.max_over(x, mesh.world)
    out["shift"] = comm.ring_shift([x], mesh.world)[0]
    pieces = [torch.full((r + 1, 2), float(10 * r + j)) for j in range(mesh.size)]
    recv = [(j + 1) * 2 * 4 for j in range(mesh.size)]
    got = comm.all_to_all_bytes(pieces, recv, mesh.world, torch.device("cpu"))
    out["a2a"] = [g.view(torch.float32).reshape(-1, 2) for g in got]
    return out


def _ring_case(mesh, seed, b, h, m, d, track=False):
    from multimodal_path_omic_tpu_torch.parallel import ring

    q, k, v, mask = attn_inputs(seed, b, h, m, m, d, mesh.seq)
    loc = [_leaf(_rows_patches(t, mesh, 0, 2)) for t in (q, k, v)]
    lmask = torch.from_numpy(_rows_patches(mask, mesh, 0, 1))
    peak = [0]
    real = torch.matmul

    def tracked(a, bb):  # the largest product a ring step forms
        res = real(a, bb)
        peak[0] = max(peak[0], res.shape[-2] * res.shape[-1])
        return res

    if track:
        torch.matmul = tracked
    try:
        o = ring.ring_self_attention(*loc, lmask, mesh)
        dout = torch.from_numpy(_rows_patches(rng_array(seed + 9, (b, h, m, d)), mesh, 0, 2))
        (o * dout).sum().backward()
    finally:
        torch.matmul = real
    return {"o": o.detach(), "grads": [t.grad for t in loc], "peak": peak[0]}


def _cross_case(mesh, seed, pre_gate, ssq, rate, philox):
    from multimodal_path_omic_tpu_torch.ops.layers import ShardedDraws
    from multimodal_path_omic_tpu_torch.parallel import ring

    b, h, n, m, d = 4, 2, 6, 64, 16
    q, k, v, mask = attn_inputs(seed, b, h, n, m, d, mesh.seq)
    ql = _leaf(_rows_patches(q, mesh, 0))
    kl, vl = (_leaf(_rows_patches(t, mesh, 0, 2)) for t in (k, v))
    lmask = torch.from_numpy(_rows_patches(mask, mesh, 0, 1))
    gen = ShardedDraws(torch.Generator().manual_seed(seed), mesh)
    res = ring.sequence_parallel_cross_attention(
        ql, kl, vl, lmask, mesh, pre_gate=pre_gate, dropout_rate=rate, generator=gen,
        philox=philox, need_ssq=ssq)
    o, s = (res if ssq else (res, None))
    loss = (o * torch.from_numpy(_rows_patches(rng_array(seed + 9, (b, h, n, d)), mesh, 0))).sum()
    if ssq:
        loss = loss + s.sum()
    (loss / mesh.seq).backward()  # every seq rank holds the merged loss: its share
    return {"o": o.detach(), "ssq": None if s is None else s.detach(),
            "grads": [t.grad for t in (ql, kl, vl)]}


def _pool_case(mesh, seed, training):
    from multimodal_path_omic_tpu_torch.ops.blocks import GatedMILPool
    from multimodal_path_omic_tpu_torch.ops.layers import ShardedDraws, set_mesh

    pool = GatedMILPool(16, dropout_rate=0.25)
    torch.manual_seed(seed)
    for p in pool.parameters():
        torch.nn.init.normal_(p, std=0.3)
    set_mesh(pool, mesh).train(training)
    x = rng_array(seed + 1, (4, 64, 16))
    mask = attn_inputs(seed, 4, 1, 1, 64, 1, mesh.seq)[3]
    xl = _leaf(_rows_patches(x, mesh, 0, 1))
    gen = ShardedDraws(torch.Generator().manual_seed(seed), mesh)
    pooled, a = pool(xl, torch.from_numpy(_rows_patches(mask, mesh, 0, 1)), gen)
    y = torch.from_numpy(_rows_patches(rng_array(seed + 2, (4, 16)), mesh, 0))
    ((pooled * y).sum() / mesh.seq).backward()  # the merged loss: each seq rank its share
    return {"pooled": pooled.detach(), "a": a.detach(), "dx": xl.grad,
            "grads": {k: p.grad.clone() for k, p in pool.named_parameters()}}


def _sharded_kernel_case(mesh, seed):
    """fused_attention_sharded (plain-K) and fused_attention_leank_sharded
    (fuse-K) with dropout on this rank's rows."""
    from multimodal_path_omic_tpu_torch.ops import coattn
    from multimodal_path_omic_tpu_torch.ops.layers import ShardedDraws

    b, h, n, m, d = 4, 1, 6, 96, 128
    q, k, v, mask = attn_inputs(seed, b, h, n, m, d, 1)
    ql, kl, vl = (_leaf(_rows_patches(t, mesh, 0)) for t in (q, k, v))
    lmask = torch.from_numpy(_rows_patches(mask, mesh, 0))
    gen = ShardedDraws(torch.Generator().manual_seed(seed), mesh)
    o, ssq = coattn.fused_attention_sharded(ql, kl, vl, lmask, mesh=mesh, pre_gate=True,
                                            dropout_rate=0.25, generator=gen, need_ssq=True)
    (o.sum() + ssq.sum()).backward()
    out = {"plain_o": o.detach(), "plain_ssq": ssq.detach(),
           "plain_grads": [t.grad for t in (ql, kl, vl)]}
    kv = _leaf(_rows_patches(rng_array(seed + 5, (b, m, 64)), mesh, 0))
    wk, bk = _leaf(rng_array(seed + 6, (64, d), 0.1)), _leaf(rng_array(seed + 7, (d,), 0.1))
    qf = _leaf(_rows_patches(q[:, 0], mesh, 0))
    seed_t = torch.tensor([1234], dtype=torch.int32)
    o2, s2, w2 = coattn.fused_attention_leank_sharded(
        qf, kv, wk, bk, lmask, mesh=mesh, dropout_rate=0.25, dropout_seed=seed_t,
        need_ssq=True, need_sumw=True)
    (o2.sum() + s2.sum() + w2.sum()).backward()
    out.update(leank_o=o2.detach(), leank_ssq=s2.detach(), leank_sumw=w2.detach(),
               leank_grads=[t.grad for t in (qf, kv, wk, bk)])
    return out


def parallel_cases(seed: int):
    """Every case of ``test_torch_port_parallel`` on this rank: the
    collectives on the world, then per mesh shape (world 2: 1x2 and 2x1;
    world 4: 1x4 and 2x2) the ring, the stat merge, the merged pool and
    (data axis > 1) the per-rank kernel wrappers."""
    import torch.distributed as dist

    from multimodal_path_omic_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size()
    shapes = ((1, 2), (2, 1)) if world == 2 else ((1, 4), (2, 2))
    out = {"comm": _comm_case(make_mesh(world, 1, device="cpu"))}
    for data, seq in shapes:
        mesh = make_mesh(data, seq, device="cpu")
        tag = f"{data}x{seq}"
        if seq > 1:
            out[f"ring/{tag}"] = _ring_case(mesh, seed, 2, 2, 64 * seq, 8)
            if data == 1 and seq == 2:
                out[f"ring_memory/{tag}"] = _ring_case(mesh, seed, 1, 1, 2048, 8, track=True)
            for pre_gate in (False, True):
                for ssq in (False, True):
                    out[f"cross/{tag}/pg{int(pre_gate)}/ssq{int(ssq)}"] = _cross_case(
                        mesh, seed, pre_gate, ssq, 0.0, True)
            for philox in (True, False):
                out[f"cross_dropout/{tag}/philox{int(philox)}"] = _cross_case(
                    mesh, seed, True, True, 0.25, philox)
            for training in (False, True):
                out[f"pool/{tag}/train{int(training)}"] = _pool_case(mesh, seed, training)
        if data > 1:
            out[f"sharded_kernels/{tag}"] = _sharded_kernel_case(mesh, seed)
    return out


# ------------------------------------------------------------ cox on a mesh

# months of the cox cohort's rows: ties and interleavings across the data
# ranks of every batch below (rank 0 holds a global batch's first rows)
COX_MONTHS = (40.0, 10.0, 25.0, 60.0, 40.0, 25.0, 5.0, 33.0, 60.0, 12.0, 25.0, 10.0)
COX_CENSOR = (0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0)
# each step's cohort rows: 7 real rows of an 8-row batch, the zero-weight
# filler (build_meta: a repeat of the last row) last, on data rank 1
COX_ROWS = ((0, 1, 2, 3, 4, 5, 6), (7, 8, 9, 10, 11, 0, 1), (3, 2, 5, 4, 6, 9, 8))
COX_B, COX_M = 8, 64


class TinyCohort:
    """A survival cohort in host memory for the cached step: ``bag(i)``
    [M_i, 64] and the ``table`` columns ``survival_extras`` reads, from a
    numpy seed; the months and censorship of :data:`COX_MONTHS`."""

    def __init__(self, seed: int = 5, wsi_dim: int = 64):
        rng = np.random.default_rng(seed)
        n = len(COX_MONTHS)
        self.lengths = rng.integers(COX_M // 3, COX_M + 1, n)
        self.bags = [rng_array(seed + 1 + i, (int(m), wsi_dim)) for i, m in
                     enumerate(self.lengths)]
        self.table = self
        self.survival_months = np.asarray(COX_MONTHS, np.float32)
        self.censorship = np.asarray(COX_CENSOR, np.float32)
        self.survival_class = rng.integers(0, 4, n)
        self.signature_names = [f"sig{j}" for j in range(len(SIZES))]
        self.signature_data = {name: rng_array(seed + 50 + j, (n, size))
                               for j, (name, size) in enumerate(zip(self.signature_names,
                                                                    SIZES))}

    def __len__(self):
        return len(self.bags)

    def bag(self, i):
        return self.bags[i]


def cox_batch(ds: TinyCohort, rows):
    """The host-fed global batch of ``rows`` (padded to COX_B with
    zero-weight repeats of the last row, as ``build_meta`` pads), numpy."""
    full = list(rows) + [rows[-1]] * (COX_B - len(rows))
    wsi = np.zeros((COX_B, COX_M, ds.bags[0].shape[1]), np.float32)
    mask = np.zeros((COX_B, COX_M), bool)
    for i, r in enumerate(full):
        wsi[i, :ds.lengths[r]] = ds.bags[r]
        mask[i, :ds.lengths[r]] = True
    t = ds.table
    return {"wsi": wsi, "mask": mask,
            "omics_packed": np.concatenate([t.signature_data[n][full]
                                            for n in t.signature_names], axis=1),
            "label": t.survival_class[full].astype(np.int64),
            "censorship": t.censorship[full], "survival_months": t.survival_months[full],
            "weight": (np.arange(COX_B) < len(rows)).astype(np.float32)}


def cox_steps(name: str, data: int, seq: int, cached: bool, params):
    """Three SGD steps of the cox loss on COX_ROWS (host-fed: this rank's
    slices of :func:`cox_batch`; cached: a sharded DeviceBagCache of the
    same cohort) from the JAX parameter tree ``params``, then the eval step
    on the first batch; dropout 0. Returns the losses, the gradients after
    step 1, the final parameters and the eval step's loss and risk."""
    from multimodal_path_omic_tpu_torch.data.device_cache import DeviceBagCache, build_meta
    from multimodal_path_omic_tpu_torch.data.pipeline import survival_extras
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.parallel.mesh import make_mesh
    from multimodal_path_omic_tpu_torch.train.loop import (
        init_train_state,
        make_cached_train_step,
        make_eval_step,
        make_train_step,
    )
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params

    mesh = make_mesh(data, seq, device="cpu") if data * seq > 1 else None
    ds = TinyCohort()
    model = build_model(name, omic_sizes=SIZES, model_size="small", dropout=0.0, wsi_dim=64,
                        mesh=mesh)
    load_jax_params(model, params)
    opt = make_optimizer("sgd", 0.05)
    state = init_train_state(model, opt, 0)
    kw = dict(omic_sizes=SIZES, patch_budget=None, mesh=mesh)
    if cached:
        cache = DeviceBagCache(ds, survival_extras, (COX_M,), device="cpu",
                               lengths=ds.lengths, mesh=mesh)
        step = make_cached_train_step(model, "cox", opt, **kw)
        inputs = [(cache.caches[COX_M], build_meta(list(rows), COX_B, cache)[0])
                  for rows in COX_ROWS]
    else:
        step = make_train_step(model, "cox", opt, **kw)
        inputs = []
        for rows in COX_ROWS:
            batch = cox_batch(ds, rows)
            inputs.append((local_batch(batch, mesh) if mesh is not None else {
                k: torch.from_numpy(v) for k, v in batch.items()},))
    out = {"loss": []}
    for i, args in enumerate(inputs):
        state, met = step(state, *args)
        out["loss"].append(float(met.loss))
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    out["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    ev = make_eval_step(model, "cox", cached=cached, **{k: v for k, v in kw.items()
                                                         if k != "patch_budget"})
    res = ev(*inputs[0])
    out["eval_loss"], out["eval_risk"] = float(res["loss"]), res["risk"].clone()
    return out


# ------------------------------------------------- attention maps on a mesh


def export_batch(b: int, m: int, seed: int, seq: int):
    """A survival batch whose bag 0 has every valid patch in seq rank 0's
    part and bag 1 no valid patch."""
    batch = survival_batch(b, m, 64, seed, n_real=b)
    batch["mask"][0, :] = False
    batch["mask"][0, :m // seq - 3] = True
    batch["mask"][1, :] = False
    return batch


def export_maps(name: str, data: int, seq: int, params, b: int = 4, m: int = 128):
    """The eval step's attention maps with ``need_attention`` (GE: its
    'path' scores) on :func:`export_batch`, this rank's slice of it."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.parallel.mesh import make_mesh
    from multimodal_path_omic_tpu_torch.train.loop import make_eval_step
    from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params

    mesh = make_mesh(data, seq, device="cpu") if data * seq > 1 else None
    ge = name.lower().startswith("ge")
    model = build_model(name, omic_sizes=SIZES, model_size="small", dropout=0.0, wsi_dim=64,
                        mesh=mesh)
    load_jax_params(model, params)
    batch = export_batch(b, m, 0, 2)
    if ge:
        batch = {k: batch[k] for k in ("wsi", "mask", "label", "weight")}
        batch["label"] = batch["label"] % 3
    dev = local_batch(batch, mesh) if mesh is not None else {
        k: torch.from_numpy(v) for k, v in batch.items()}
    step = make_eval_step(model, "ce" if ge else "ces", ge_mode=ge, need_attention=not ge,
                          omic_sizes=SIZES, mesh=mesh)
    res = step(dev)
    attn = res["attention"]
    return {"map": attn["path" if ge else "coattn"].clone(), "y": res["y"].clone()}


def leave_one_out(root: str, name: str, data: int, seq: int, params):
    """``Trainer.test(1, save=True)`` of ``name`` on the 1024-wide cohort
    under ``root`` with ``params`` (a JAX parameter tree) loaded; returns
    the map rank 0 wrote (None on the other ranks) and the names written,
    or the exception raised, as text."""
    import glob
    import os

    import torch.distributed as dist

    from multimodal_path_omic_tpu_torch.config import config_from_dict
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer
    from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params

    out_dir = os.path.join(root, f"loo-{name}-{data}x{seq}")
    raw = loo_config(root, name, data, seq)
    raw["training"]["test_output_dir"] = out_dir
    t = Trainer(config_from_dict(raw), verbose=False, device="cpu")
    load_jax_params(t.model, params)
    try:
        t.test(1, save=True)
    except ValueError as exc:
        return {"raised": f"{type(exc).__name__}: {exc}"}
    dist.barrier()  # rank 0 has written
    names = sorted(os.path.basename(f) for f in glob.glob(os.path.join(out_dir, "ATTN_*")))
    res = {"names": names}
    if dist.get_rank() == 0 and names:
        res["map"] = np.load(os.path.join(out_dir, names[0]))
    return res


def loo_config(root: str, name: str, data: int = 1, seq: int = 1):
    """The leave-one-out config dict of the 1024-wide cohort under ``root``
    (the JAX Trainer builds 1024-wide models), for the port and for JAX."""
    import os

    from multimodal_path_omic_tpu_torch.data.synthetic import (
        make_synthetic_cohort,
        synthetic_config_dict,
    )

    cohort = os.path.join(root, "loo_cohort")
    paths = (os.path.join(cohort, "cohort.csv"), os.path.join(cohort, "signatures.csv"),
             os.path.join(cohort, "patches"))
    if not os.path.exists(paths[0]):
        paths = make_synthetic_cohort(cohort, n_patients=12, bag_lengths=(40, 90, 120),
                                      n_genes=24, n_signatures=4, embedding_dim=1024, seed=0)
    raw = synthetic_config_dict(*paths)
    ge = name.lower().startswith("ge")
    raw["device"] = "cpu"
    raw["model"].update(name=name, model_size="small", dropout=0.0,
                        checkpoint_dir=os.path.join(root, f"ck-loo-{name}-{data}x{seq}"))
    if ge:
        raw["model"]["gene"] = "G000"
    raw["training"].update(loss="ce" if ge else "cesar", epochs=1, optimizer="sgd", lr=0.05,
                           leave_one_out="P003", output_attn_epoch=1)
    raw["tpu"] = {"bag_buckets": [64, 128], "batch_size": 2, "data_axis": data,
                  "seq_axis": seq}
    return raw


def trainer_world(root: str, specs):
    """Every (key, kind, args) of ``specs`` on this rank, in order: "fit"
    (:func:`trainer_fit`), "raises" (the exception a Trainer raises, as
    text), "steps" (:func:`train_steps`), "cox" (:func:`cox_steps`),
    "export" (:func:`export_maps`), "loo" (:func:`leave_one_out`)."""
    jobs = {"fit": lambda *a: trainer_fit(root, *a), "steps": train_steps, "cox": cox_steps,
            "export": export_maps, "loo": lambda *a: leave_one_out(root, *a)}
    out = {}
    for key, kind, args in specs:
        if kind in jobs:
            out[key] = jobs[kind](*args)
            continue
        try:
            trainer_fit(root, *args)
            out[key] = None
        except (ValueError, NotImplementedError) as exc:
            out[key] = f"{type(exc).__name__}: {exc}"
    return out



# ------------------------------------------------------- serving on a mesh


def http(url: str, body: bytes = None):
    """(status, parsed JSON or text) of a GET (``body`` None) or POST."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            code, text = resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        code, text = exc.code, exc.read().decode()
    try:
        return code, json.loads(text)
    except ValueError:
        return code, text


def wait_for(port: int, deadline_s: float = 120.0) -> None:
    """Block until ``port`` on localhost accepts a connection."""
    import socket
    import time

    t0 = time.time()
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            if time.time() - t0 > deadline_s:
                raise
            time.sleep(0.1)


def mesh_server(config_path: str, port: int, requests):
    """``server.main`` on every rank of the world (the config's mesh); rank
    0 also runs a client thread that sends ``requests``
    ((path, body or None) pairs) once the port accepts, then SIGTERM to
    every rank. Returns the exit code of ``main`` and, on rank 0, the
    answers in order."""
    import os
    import signal
    import threading

    import torch.distributed as dist

    from multimodal_path_omic_tpu_torch import server

    pids = [None] * dist.get_world_size()
    dist.all_gather_object(pids, os.getpid())
    answers = []

    def client():
        try:
            wait_for(port)
            answers.extend(http(f"http://127.0.0.1:{port}{path}", body)
                           for path, body in requests)
        finally:
            for pid in pids:  # as torchrun signals every rank
                os.kill(pid, signal.SIGTERM)

    if dist.get_rank() == 0:
        threading.Thread(target=client, daemon=True).start()
    rc = server.main(["--config", config_path, "--port", str(port)])
    return {"rc": rc, "answers": answers}
