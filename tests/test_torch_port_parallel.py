"""Data parallelism in the port (diagan_tpu_torch.parallel and its callers:
train/{state,steps,logit_recorder,trainer,stylegan2_trainer}.py and the
CLIs) against its definitions and the JAX package's 2-device mesh.

Ranks are subprocesses (tests/test_torch_port_parallel_worker.py) that
import torch and the port only, one thread each, joined in a gloo group
through a FileStore in tmp_path (no TCP port: the suite runs test files in
parallel processes).
The JAX side runs here on 2 of conftest's 8 CPU devices.

  (a) the collectives at world 2 against their definitions;
      shard_logit_gather and per_rank_shard against the JAX
      shard_logit_gather / per_host_shard on the same inputs;
  (b) one SNGAN fused step (width 32, n_dis 2, global batch 8, twin D,
      phase 2) at world 2 against make_sharded_train_chunk on a 2-device
      mesh, each device's draws injected (`stack[axis_index("data")]`) and
      each rank's ReLU sides taken from its own float64 run, with
      test_torch_port_sngan_step.py's tolerances; G's BatchNorm statistics
      after the sync at 1e-6; both ranks' states bit for bit;
  (c) the sharded logit sweep (70 images, batch 16: a ragged tail, 5
      batches padded to 6) in eval and train mode equals the one-process
      sweep bit for bit, and in eval mode JAX's sharded recorder at 1e-5 x
      max(1, max|.|);
  (d) the StyleGAN2 D step (16 px, width 1/16, batch 4 per rank, ADA):
      the averaged gradients against the mean of the JAX formulas'
      per-half gradients (test_torch_port_train.py's tolerances), the
      summed sign and the tuned p against JAX's AdaptiveAugment; the
      streamed per-rank batches against JAX `_host_stacks` split on dim 1
      with `_mesh_n = 2`;
  (e) cli.train_mimicry_color_mnist_phase1 --data_parallel --device cpu at
      2 ranks: the ranks agree, rank 0 alone writes files, and an 8-step
      run equals a 4-step run resumed to 8 (--auto_resume), bit for bit.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from test_torch_port_dcgan import jax_dcgan_d  # noqa: E402
from test_torch_port_mnist_data import write_mnist  # noqa: E402
from test_torch_port_sngan_models import jax_discriminator, jax_generator  # noqa: E402
from test_torch_port_sngan_step import (  # noqa: E402
    BETAS,
    BS,
    LR,
    N_DATA,
    N_DIS,
    NUM_STEPS,
    NZ,
    _draws,
    _grad_tree,
    recording,
)
from test_torch_port_train import _setup as sg2_setup  # noqa: E402

from diagan_tpu.models import ada as JA  # noqa: E402
from diagan_tpu.models import losses as JL  # noqa: E402
from diagan_tpu.parallel import (  # noqa: E402
    make_mesh,
    make_sharded_train_chunk,
    per_host_shard,
    replicate,
)
from diagan_tpu.parallel import shard_logit_gather as jax_shard_logit_gather  # noqa: E402
from diagan_tpu.train import steps as JS  # noqa: E402
from diagan_tpu.train.logit_recorder import LogitRecorder as JaxRecorder  # noqa: E402
from diagan_tpu.train.state import NetState as JNetState  # noqa: E402
from diagan_tpu.train.trainer import _make_tx  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.parallel import per_rank_shard, rank_block  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

WORKER = Path(__file__).with_name("test_torch_port_parallel_worker.py")
REPO = Path(__file__).resolve().parents[1]
WORLD = 2


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:WORLD])


def run_ranks(case, tmp_path, inputs, timeout=300):
    """Run `case` of the worker on WORLD ranks; returns each rank's output."""
    run = tmp_path / case
    run.mkdir()
    inputs = {**inputs, "dir": str(run)}
    torch.save(inputs, run / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(r), str(WORLD), str(run)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {case}:\n{log[-4000:]}"
    return [torch.load(run / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def equal_trees(a, b):
    """Bit-for-bit equality of nested dicts / lists of tensors and numbers."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal_trees(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


# --- (a) ------------------------------------------------------------------------
def test_collectives_match_their_definitions_and_jax(tmp_path, mesh):
    rng = np.random.default_rng(0)
    f32 = torch.from_numpy(rng.standard_normal((WORLD, 7)).astype(np.float32))
    f64 = torch.from_numpy(rng.standard_normal((WORLD, 3)))
    bn = {k: torch.from_numpy(rng.random((WORLD, 5)).astype(np.float32) + 0.5)
          for k in ("bn_mean", "bn_var", "bn_weight")}
    values = rng.standard_normal((WORLD, 4)).astype(np.float32)
    indices = rng.permutation(WORLD * 4).reshape(WORLD, 4)
    outs = run_ranks("collectives", tmp_path, {
        "f32": f32, "f64": f64, **bn, "values": torch.from_numpy(values),
        "indices": torch.from_numpy(indices)})

    want_v, want_i = jax.jit(shard_map(
        jax_shard_logit_gather, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P(), P()), check_vma=False))(jnp.asarray(values.reshape(-1)),
                                                 jnp.asarray(indices.reshape(-1)))
    for rank, out in enumerate(outs):
        # all_reduce_mean_: the sum over the ranks over the world size, per dtype
        assert torch.equal(out["mean"][0], (f32[0] + f32[1]) / WORLD)
        assert torch.equal(out["mean"][1], (f64[0] + f64[1]) / WORLD)
        assert out["mean"][1].dtype == torch.float64 and out["bytes"] == 7 * 4 + 3 * 8
        # sync_buffers averages the floating buffers, nothing else
        synced = out["bn_synced"]
        for key, name in (("running_mean", "bn_mean"), ("running_var", "bn_var")):
            assert torch.equal(synced[key], (bn[name][0] + bn[name][1]) / WORLD)
        assert int(synced["num_batches_tracked"]) == 3 + rank
        assert torch.equal(synced["weight"], bn["bn_weight"][rank])
        # broadcast_module: rank 0's parameters and buffers everywhere
        assert equal_trees(out["bn_broadcast"], outs[0]["bn_synced"])
        # shard_logit_gather: rank order, as the JAX tiled all_gather
        np.testing.assert_array_equal(out["gather"][0].numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(out["gather"][1].numpy(), np.asarray(want_i))
        assert out["any"] == [True, False]

    array = np.arange(23)
    for n in (0, 1, 7, 23):
        for world in (1, 2, 3, 4):
            parts = [per_rank_shard(array[:n], r, world) for r in range(world)]
            for r, part in enumerate(parts):
                np.testing.assert_array_equal(
                    part, per_host_shard(array[:n], process_index=r, num_processes=world))
            np.testing.assert_array_equal(np.concatenate(parts), array[:n])
            # rank_block: the sharded sweep's contiguous blocks of a padded list
            blocks = [rank_block(n, r, world) for r in range(world)]
            assert blocks[0][0] == 0 and blocks[-1][1] == n
            assert all(b[1] == c[0] for b, c in zip(blocks, blocks[1:]))
            assert all(hi - lo <= -(-n // world) for lo, hi in blocks)


def test_init_without_torchrun_refuses_several_cards(monkeypatch):
    """With more than one card visible and no torchrun environment, the
    group is not formed: the error names the torchrun command."""
    import torch.distributed as dist

    from diagan_tpu_torch.parallel import init_data_parallel

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc_per_node=4"):
        init_data_parallel("cuda")


# --- (b) ------------------------------------------------------------------------
STEP = 7  # phase 2, GOLD off


def _per_device(stack):
    return jnp.asarray(stack)[jax.lax.axis_index("data")]


def _jax_sharded_step(mesh, draws, images, masks, monkeypatch):
    gen, gv = jax_generator("32")
    disc, dv = jax_discriminator("32")
    _, drs_v = jax_discriminator("32", seed=4)
    cfg = JS.StepConfig(n_dis=N_DIS, batch_size=BS, nz=NZ, loss_type="hinge",
                        drs_loss_type="ns", model="sngan", gold=False, gold_step=0, topk=False,
                        epoch_steps=2, use_drs=True, quantized=True, axis_name="data")
    tx_g = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", 1), 1)
    tx_d = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", N_DIS), N_DIS)
    tx_dd = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", N_DIS), N_DIS)

    def state(v, tx, coll):
        return replicate(JNetState(v["params"], {coll: v[coll]}, tx.init(v["params"]),
                                   jnp.zeros((), jnp.int32)), mesh)

    def stacked(kind, i):
        return np.stack([d[kind][i] for d in draws])

    real = iter([stacked("real", i) for i in range(N_DIS)])
    drs = iter([stacked("drs", i) for i in range(N_DIS)])
    normals = iter([stacked(k, i) for i in range(N_DIS) for k in ("z", "drs_z")]
                   + [stacked("g_z", N_DIS - 1)])
    sides = iter([np.stack([m.numpy().transpose(0, 2, 3, 1) if m.ndim == 4 else m.numpy()
                            for m in ms]) for ms in zip(*masks)])
    monkeypatch.setattr(JS, "_sample_idx",
                        lambda *a: _per_device(next(real)).astype(jnp.int32))
    monkeypatch.setattr(JS, "sample_uniform_indices",
                        lambda *a: _per_device(next(drs)).astype(jnp.int32))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: _per_device(next(normals)))
    monkeypatch.setattr(flax.linen, "relu", lambda x: jnp.where(_per_device(next(sides)), x, 0.0))
    fused = JS.make_fused_step(gen, disc, disc, tx_g, tx_d, tx_dd, cfg, N_DATA, N_DATA)
    chunk = make_sharded_train_chunk(fused, 1, mesh, donate=False)
    images_j = replicate(jnp.asarray(images), mesh)
    out = chunk(state(gv, tx_g, "batch_stats"), state(dv, tx_d, "spectral"),
                state(drs_v, tx_dd, "spectral"), images_j, images_j,
                replicate(jnp.zeros(N_DATA), mesh), jax.random.key(0), jnp.int32(STEP), None)
    for it in (real, drs, normals, sides):
        assert next(it, None) is None  # every draw and ReLU side consumed
    monkeypatch.undo()
    return jax.device_get(out)


def test_sngan_step_at_world_2_matches_the_jax_mesh(tmp_path, mesh, monkeypatch):
    images = synthetic_natural(N_DATA, 32, seed=9)[0]
    rng = np.random.default_rng(11)
    draws = [_draws("phase2", rng) for _ in range(WORLD)]
    gv, dv, drs_v = (jax_generator("32")[1], jax_discriminator("32")[1],
                     jax_discriminator("32", seed=4)[1])
    outs = run_ranks("sngan_step", tmp_path, {
        "g": jax_params.sngan_generator_state_dict(gv),
        "d": jax_params.sngan_discriminator_state_dict(dv),
        "dd": jax_params.sngan_discriminator_state_dict(drs_v),
        "images": images, "draws": draws,
        "cfg": {"width": 32, "n_dis": N_DIS, "batch": BS * WORLD, "nz": NZ, "lr": LR,
                "betas": BETAS, "num_steps": NUM_STEPS, "step": STEP}})
    # the ranks stay replicas: the same weights, u and (synced) running statistics
    assert equal_trees(outs[0]["state"], outs[1]["state"])
    assert equal_trees(outs[0]["grads"], outs[1]["grads"])
    assert outs[0]["counts"] == [1, N_DIS, N_DIS]

    g_j, d_j, dd_j, m_j = _jax_sharded_step(mesh, draws, images,
                                            [o["masks"] for o in outs], monkeypatch)
    m_t = {k: np.mean([o["metrics"][k] for o in outs]) for k in outs[0]["metrics"]}
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k], float(np.asarray(m_j[k])[0]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    grads, state = outs[0]["grads"], outs[0]["state"]
    for name, js, bridge, coll in (
            ("g", g_j, jax_params.sngan_generator_state_dict, "batch_stats"),
            ("d", d_j, jax_params.sngan_discriminator_state_dict, "spectral"),
            ("dd", dd_j, jax_params.sngan_discriminator_state_dict, "spectral")):
        rec = js.opt_state[0]
        masks = {}
        for k, got in enumerate(grads[name]):  # the pmean'd / all-reduced gradients
            want = _grad_tree(bridge, jax.tree.map(lambda r: r[k], rec), {coll: js.state[coll]})
            want = {key: w for key, w in want.items() if key in got}
            assert len(want) == len(got)
            for key, w in want.items():
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-3, atol=1e-5 * scale,
                                           err_msg=f"{name} update {k} grad {key}")
                big = np.abs(w) > max(1e-4 * np.abs(w).max(), 1e-5 * scale)
                masks[key] = masks.get(key, True) & big
        after = {k: t.numpy() for k, t in
                 bridge({"params": js.params, coll: js.state[coll]}).items()}
        for key, w in after.items():
            ours = state[name][key].numpy()
            if key.endswith(("weight_u", "running_mean", "running_var")):
                np.testing.assert_allclose(ours, w, atol=1e-6, err_msg=f"{name} {key}")
            elif key in masks:
                m = masks[key]
                np.testing.assert_allclose(ours[m], w[m], rtol=0, atol=1e-6,
                                           err_msg=f"{name} param {key} after the step")


# --- (c) ------------------------------------------------------------------------
def test_sharded_sweep_equals_one_process_and_jax(tmp_path, mesh):
    n, bs, seed, step = 70, 16, 1, 40
    images = synthetic_natural(n, 32, seed=12)[0]
    disc, v = jax_dcgan_d()
    outs = run_ranks("sweep", tmp_path, {
        "d": jax_params.mnist_dcgan_discriminator_state_dict(v), "images": images,
        "batch": bs, "seed": seed, "step": step})
    for out in outs:
        for mode in ("eval", "train"):
            sharded, single = out[mode]
            assert torch.equal(sharded, single), mode
            assert torch.equal(sharded, outs[0][mode][0]), mode
    assert not torch.equal(outs[0]["eval"][0], outs[0]["train"][0])

    state = {k: v[k] for k in v if k != "params"}

    def fwd(p, s, batch, rng):
        return disc.apply({"params": p, **s}, batch, update_stats=False, train=False,
                          rngs={"dropout": rng}), s

    rec = JaxRecorder(n, 2, batch_size=bs, mesh=mesh)
    rec.record(fwd, v["params"], state, replicate(jnp.asarray(images), mesh), step,
               key=jax.random.key(9))
    want = np.asarray(rec.buffer[0])
    np.testing.assert_allclose(outs[0]["eval"][0].numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


# --- (d) ------------------------------------------------------------------------
SG2_CUTOFF, P_AUG, SG2_BS = 3, 0.7, 4


def _sg2_draws(seed):
    """One rank's draws of a D step (test_torch_port_train.py's recipe)."""
    from test_torch_port_generator import STYLE_DIM

    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    noise = [(SG2_BS, 4, 4, 1)] + [(SG2_BS, r, r, 1) for r in (8, 8, 16, 16)]
    d = {"real": np.tanh(normal(SG2_BS, 16, 16, 3)), "z1": normal(SG2_BS, STYLE_DIM),
         "z2": normal(SG2_BS, STYLE_DIM), "noises": [normal(*s) for s in noise]}
    affine = jax.jit(JA.sample_affine_matrices, static_argnums=(1, 2, 3, 4))
    color = jax.jit(JA.sample_color_matrices, static_argnums=(1, 2))
    for i in range(2):
        k1, k2 = jax.random.split(jax.random.key(seed * 10 + i))
        d[f"aug{i}"] = (np.array(affine(k1, SG2_BS, P_AUG, 16, 16)),
                        np.array(color(k2, SG2_BS, P_AUG)))
    return d


def test_stylegan2_d_step_ada_sign_and_streams_at_world_2(tmp_path):
    from test_torch_port_ffhq_flags import jax_trainer
    from test_torch_port_generator import N_MLP, STYLE_DIM, WIDTH
    from test_torch_port_train import PAD_BUCKETS, _jax_synth

    from diagan_tpu.native import io as JN

    gen, gparams, disc, dparams, _ = sg2_setup()
    draws = [_sg2_draws(seed) for seed in (31, 32)]
    images = synthetic_natural(40, 16, seed=2)[0]
    scores = np.random.default_rng(4).random(40) + 0.05
    outs = run_ranks("stylegan2", tmp_path, {
        "g": jax_params.generator_state_dict(gparams),
        "d": jax_params.discriminator_state_dict(dparams),
        "images": images, "scores": scores, "draws": draws,
        "cfg": {"size": 16, "style_dim": STYLE_DIM, "n_mlp": N_MLP, "width": WIDTH,
                "batch": SG2_BS, "cutoff": SG2_CUTOFF, "p_aug": P_AUG, "stream_seed": 5}})

    def augment(x, aug):
        out = JA.apply_affine(x, jnp.asarray(aug[0]), pad_buckets=PAD_BUCKETS)
        return JA.apply_color(out, jnp.asarray(aug[1]))

    def loss_fn(p, gp, d):
        fake = _jax_synth(gen, gp, lambda m: m.sample([jnp.asarray(d["z1"]),
                                                       jnp.asarray(d["z2"])], SG2_CUTOFF),
                          d["noises"])
        rp = disc.apply({"params": p}, augment(jnp.asarray(d["real"]), d["aug0"]))[0]
        fp = disc.apply({"params": p}, augment(jax.lax.stop_gradient(fake), d["aug1"]))[0]
        return JL.d_logistic_loss(rp, fp), jnp.sum(jnp.sign(rp))

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    halves = [step(dparams, gparams, d) for d in draws]
    mean_grads = jax.tree.map(lambda a, b: (a + b) / 2, halves[0][1], halves[1][1])
    want = jax_params.discriminator_state_dict(jax.device_get(mean_grads))
    sign_sum = sum(float(h[0][1]) for h in halves)
    ada = JA.AdaptiveAugment(update_every=SG2_BS * WORLD)
    want_p = ada.tune(sign_sum, SG2_BS * WORLD)

    for rank, out in enumerate(outs):
        (loss, sign), _ = halves[rank]
        np.testing.assert_allclose(out["loss"], float(loss), atol=3e-4, rtol=1e-3)
        assert out["local_sign"] == float(sign)
        assert out["sign"] == sign_sum and out["p"] == want_p and out["r_t"] == ada.r_t_stat
        assert set(out["grads"]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(out["grads"][name].numpy(), w.numpy(), atol=3e-4,
                                       rtol=1e-3, err_msg=name)
    assert equal_trees(outs[0]["grads"], outs[1]["grads"])
    assert equal_trees(outs[0]["d_after"], outs[1]["d_after"])

    # the streamed batches: each rank's slice of the JAX trainer's global stack
    jt = jax_trainer(tmp_path / "jax", images, drs=True, sample_weights=scores, d_reg_every=16,
                     g_reg_every=4, augment_p=None, seed=5, stream_data=True)
    jt._mesh_n = WORLD
    jt._gather = JN.gather_u8
    stacks = []
    for s in (0, 1):
        xs, r1 = jt._host_stacks(s, 1)
        stacks += [xs["d"][0], xs["drs"][0]] + ([r1["d"][0], r1["drs"][0]] if s == 0 else [])
    for rank, out in enumerate(outs):
        assert len(out["stream"]) == len(stacks) == 6
        for got, stack in zip(out["stream"], stacks):
            part = torch.from_numpy(np.array(stack[rank * SG2_BS:(rank + 1) * SG2_BS]))
            assert torch.equal(got, part.float() / 127.5 - 1.0)


# --- (e) ------------------------------------------------------------------------
def test_mnist_cli_at_world_2_agrees_writes_once_and_resumes(tmp_path):
    root = tmp_path / "data"
    write_mnist(root, n=300)
    common = ["--device", "cpu", "--data_parallel", "--num_data", "64", "--batch_size", "8",
              "--logit_save_steps", "4", "-r", str(root), "--seed", "3"]

    def run(rank, name, steps, work, extra=()):
        return (name, common + ["--num_steps", str(steps), "--work_dir", str(work),
                                "--exp_name", name, *extra])

    runs = [[run(r, "straight", 8, tmp_path / f"work{r}"),  # rank 1 writes to work1
             run(r, "resumed", 4, tmp_path / "shared"),
             run(r, "resumed", 8, tmp_path / "shared", ["--auto_resume"])] for r in range(WORLD)]
    runs = [[(f"{name}_{i}", argv) for i, (name, argv) in enumerate(rs)] for rs in runs]
    outs = run_ranks("mnist_cli", tmp_path, {"runs": runs})
    assert equal_trees(outs[0], outs[1])  # the ranks agree
    straight, half, resumed = (outs[0][k] for k in ("straight_0", "resumed_1", "resumed_2"))
    assert (straight["global_step"], half["global_step"], resumed["global_step"]) == (8, 4, 8)
    assert straight["counts"] == [(8, 8), (8, 8)] and straight["logits"].shape == (2, 64)
    assert equal_trees(straight, resumed)  # 8 steps = 4 + 4, bit for bit

    # rank 0 alone writes: rank 1's work directory holds no file
    assert not [p for p in (tmp_path / "work1").rglob("*") if p.is_file()]
    run0 = tmp_path / "work0" / "straight"
    for net in ("netG", "netD"):
        assert (run0 / "checkpoints" / net / f"{net}_8_steps.pth").is_file()
    assert (run0 / "scalars.jsonl").is_file() and (run0 / "eval_p1_samples.png").is_file()
    with open(run0 / "logits_netD_train.pkl", "rb") as f:
        logits = pickle.load(f)
    assert list(logits) == [4, 8] and all(v.shape == (64,) for v in logits.values())
    assert (run0 / "logits_netD_train.pkl").read_bytes() == \
        (tmp_path / "shared" / "resumed" / "logits_netD_train.pkl").read_bytes()
