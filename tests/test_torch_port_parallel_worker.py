"""One rank of the data-parallel tests (tests/test_torch_port_parallel.py).

    python tests/test_torch_port_parallel_worker.py CASE RANK WORLD DIR

Joins a gloo group through a FileStore (DIR/store), runs CASE on its inputs
(DIR/inputs.pt, written by the test) and writes what the test compares to
DIR/rank{RANK}.pt. It imports torch and the port only, and pins torch to one
thread: the test suite runs several test files at once.
"""
from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diagan_tpu_torch.parallel import (  # noqa: E402
    all_reduce_mean_,
    broadcast_module,
    init_data_parallel,
    shard_logit_gather,
    sync_buffers,
)


# --- (a) the collectives ------------------------------------------------------
def collectives(dp, inp):
    out = {}
    ts = [inp["f32"][dp.rank].clone(), inp["f64"][dp.rank].clone()]
    all_reduce_mean_(ts, dp)
    out["mean"] = ts
    out["bytes"] = dp.bytes_all_reduced
    from diagan_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(5, device="cpu")
    with torch.no_grad():
        bn.running_mean.copy_(inp["bn_mean"][dp.rank])
        bn.running_var.copy_(inp["bn_var"][dp.rank])
        bn.num_batches_tracked.fill_(3 + dp.rank)
        bn.weight.copy_(inp["bn_weight"][dp.rank])
    sync_buffers(bn, dp)
    out["bn_synced"] = {k: v.clone() for k, v in bn.state_dict().items()}
    broadcast_module(bn, dp)
    out["bn_broadcast"] = {k: v.clone() for k, v in bn.state_dict().items()}
    out["gather"] = shard_logit_gather(inp["values"][dp.rank], inp["indices"][dp.rank], dp)
    out["any"] = [dp.any(dp.rank == 1), dp.any(False)]
    dp.barrier()
    return out


# --- (b) one SNGAN fused step -----------------------------------------------------
class Draws:
    """The step's draws, from the test's arrays, in the step's dtype."""

    def __init__(self, draws, dtype):
        self.draws, self.dtype = draws, dtype

    def indices(self, kind, i, source, n):
        return torch.from_numpy(self.draws[kind][i]).long()

    def normal(self, kind, i, n, nz, device):
        return torch.from_numpy(self.draws[kind][i]).to(self.dtype)


class ReluSides:
    """Record a run's ReLU masks, or apply recorded ones in call order."""

    def __init__(self, masks=None):
        self.masks, self.used = ([] if masks is None else masks), 0

    def record(self, orig):
        def relu(x, *a, **k):
            self.masks.append(x.detach() > 0)
            return orig(x)
        return relu

    def apply(self, x, *a, **k):
        m = self.masks[self.used]
        self.used += 1
        assert m.shape == x.shape, (m.shape, x.shape)
        return torch.where(m, x, torch.zeros((), dtype=x.dtype))


def _sngan_step(dp, inp, dtype, relu):
    from diagan_tpu_torch.data.arrays import ArrayDataset
    from diagan_tpu_torch.data.pipeline import DeviceDataSource
    from diagan_tpu_torch.models import sngan
    from diagan_tpu_torch.models.registry import OptSpec
    from diagan_tpu_torch.train.state import NetState
    from diagan_tpu_torch.train.steps import StepConfig, make_fused_step

    c = inp["cfg"]

    class Source(DeviceDataSource):
        def gather(self, idx):
            return super().gather(idx).to(dtype)

    def net(cls, width, sd, ups):
        m = cls(**width, device="cpu")
        m.load_state_dict(sd)
        return NetState(m.to(dtype), OptSpec(c["lr"], c["betas"]), c["num_steps"], "linear", ups,
                        data_parallel=dp)

    g = net(sngan.SNGANGenerator32, {"ngf": c["width"]}, inp["g"], 1)
    d = net(sngan.SNGANDiscriminator32, {"ndf": c["width"]}, inp["d"], c["n_dis"])
    dd = net(sngan.SNGANDiscriminator32, {"ndf": c["width"]}, inp["dd"], c["n_dis"])
    grads = {}
    for name, n in (("g", g), ("d", d), ("dd", dd)):
        named = list(n.module.named_parameters())
        n.optim.register_step_pre_hook(  # after apply_update's all-reduce
            lambda opt, args, kwargs, name=name, named=named: grads.setdefault(name, []).append(
                {k: p.grad.detach().clone() for k, p in named}))
    ds = ArrayDataset.from_images(inp["images"])
    cfg = StepConfig(n_dis=c["n_dis"], batch_size=c["batch"] // dp.world, nz=c["nz"],
                     loss_type="hinge", drs_loss_type="ns", model="sngan", gold=False,
                     gold_step=0, topk=False, epoch_steps=2, use_drs=True)
    fused = make_fused_step(g, d, dd, cfg, Source(ds, weights=np.linspace(0.1, 1.0, len(ds)),
                                                  device="cpu"), Source(ds, device="cpu"))
    orig, torch.nn.functional.relu = torch.nn.functional.relu, relu
    try:
        metrics = fused(c["step"], Draws(inp["draws"][dp.rank], dtype))
    finally:
        torch.nn.functional.relu = orig
    for n in (g, d, dd):
        sync_buffers(n.module, dp)
    return metrics, (g, d, dd), grads


def sngan_step(dp, inp):
    """The step in float64, recording the ReLU sides, then in fp32 with them."""
    sides = ReluSides()
    _sngan_step(dp, inp, torch.float64, sides.record(torch.nn.functional.relu))
    fp32 = ReluSides(sides.masks)
    metrics, nets, grads = _sngan_step(dp, inp, torch.float32, fp32.apply)
    assert fp32.used == len(sides.masks)
    return {"masks": sides.masks,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "state": {name: n.module.state_dict() for name, n in zip(("g", "d", "dd"), nets)},
            "counts": [n.count for n in nets],
            "grads": grads}


# --- (c) the sharded logit sweep ---------------------------------------------------
def sweep(dp, inp):
    from diagan_tpu_torch.data.arrays import ArrayDataset
    from diagan_tpu_torch.data.pipeline import DeviceDataSource
    from diagan_tpu_torch.models.mnist_dcgan import MNISTDCGANDiscriminator
    from diagan_tpu_torch.train.logit_recorder import LogitRecorder
    from diagan_tpu_torch.train.steps import batch_generator, draw_keep_masks

    d = MNISTDCGANDiscriminator(nc=3, device="cpu")
    d.load_state_dict(inp["d"])
    source = DeviceDataSource(ArrayDataset.from_images(inp["images"]), device="cpu")
    n, bs, seed, step = len(inp["images"]), inp["batch"], inp["seed"], inp["step"]

    def masks(b, shapes):
        return draw_keep_masks(shapes, batch_generator(seed + 2, step, b, "cpu"), "cpu")

    out = {}
    for mode, train in (("eval", False), ("train", True)):
        rows = []
        for group in (dp, None):
            rec = LogitRecorder(n, 2, batch_size=bs, device="cpu", data_parallel=group)
            rec.record(d, source, step, train=train, dropout_masks=masks)
            rows.append(rec.buffer[0].clone())
        out[mode] = rows
    return out


# --- (d) the StyleGAN2 D step, ADA's sign and the streamed slices --------------------
def stylegan2(dp, inp):
    from diagan_tpu_torch.models import stylegan2 as T
    from diagan_tpu_torch.train import stylegan2_trainer as TT

    c = inp["cfg"]
    g = T.StyleGAN2Generator(size=c["size"], style_dim=c["style_dim"], n_mlp=c["n_mlp"],
                             width_scale=c["width"], device="cpu")
    g.load_state_dict(inp["g"])
    d = T.StyleGAN2Discriminator(size=c["size"], width_scale=c["width"], device="cpu")
    d.load_state_dict(inp["d"])
    tr = TT.StyleGAN2Trainer(Path(inp["dir"]) / "out", g, d, inp["images"], num_steps=1,
                             batch_size=c["batch"], augment_p=0, device="cpu", data_parallel=dp)
    tr.ada_aug_p = c["p_aug"]  # the augment's p for this step; ADA's own p starts at 0
    tr.ada.update_every = c["batch"] * dp.world
    named = list(tr.disc.named_parameters())
    grads = []
    tr.d_optim.register_step_pre_hook(
        lambda opt, args, kwargs: grads.append({k: p.grad.detach().clone() for k, p in named}))
    dr = inp["draws"][dp.rank]
    fakes = TT.FakeDraws(torch.from_numpy(dr["z1"]), torch.from_numpy(dr["z2"]), c["cutoff"],
                         [torch.from_numpy(x) for x in dr["noises"]])
    augs = [tuple(torch.from_numpy(a) for a in dr[f"aug{i}"]) for i in range(2)]
    m = tr.d_step(tr.disc, tr.d_optim, torch.from_numpy(dr["real"]), fakes, *augs)
    local_sign = float(m["sign_real"])
    tr.tune_ada(m)
    out = {"grads": grads[0], "loss": float(m["d"]), "local_sign": local_sign,
           "sign": float(m["sign_real"]), "p": tr.ada.ada_aug_p, "r_t": tr.ada.r_t_stat,
           "d_after": tr.disc.state_dict()}

    # stream mode: every rank draws the global stack and gathers its slice
    st = TT.StyleGAN2Trainer(Path(inp["dir"]) / "stream", g, d, inp["images"], num_steps=2,
                             batch_size=c["batch"], drs_disc=d, sample_weights=inp["scores"],
                             augment_p=None, seed=c["stream_seed"], stream_data=True,
                             d_reg_every=16, device="cpu", data_parallel=dp)
    # the order of two steps' draws (step 0 an R1 step): D, DRS-D, R1 D, R1 DRS-D; D, DRS-D
    out["stream"] = [st.draw_real(w).clone() for w in (True, False, True, False, True, False)]
    return out


# --- (e) the Colored-MNIST phase-1 CLI ------------------------------------------------
def _run_state(tr):
    nets = [n for n in (tr.g, tr.d, tr.d_drs) if n is not None]
    return {"modules": [n.module.state_dict() for n in nets],
            "optim": [n.optim.state_dict()["state"] for n in nets],
            "counts": [(n.count, n.step) for n in nets],
            "logits": tr.recorder.buffer[:tr.recorder.count].clone(),
            "global_step": tr.global_step}


def mnist_cli(dp, inp):
    from diagan_tpu_torch.cli import mnist_scripts
    from diagan_tpu_torch.cli import train_mimicry_color_mnist_phase1 as cli
    from diagan_tpu_torch.train import trainer as TT
    from diagan_tpu_torch.train.logger import Logger
    from diagan_tpu_torch.utils import plot

    TT.Logger = functools.partial(Logger, use_tensorboard=False)
    mnist_scripts.plot_color_mnist_generator = functools.partial(  # 100 samples, not 1000
        plot.plot_color_mnist_generator, num_images=100)
    out = {}
    for name, argv in inp["runs"][dp.rank]:
        out[name] = _run_state(cli.main(argv))
    return out


CASES = {"collectives": collectives, "sngan_step": sngan_step, "sweep": sweep,
         "stylegan2": stylegan2, "mnist_cli": mnist_cli}


def main(case, rank, world, run_dir):
    torch.set_num_threads(1)
    run_dir = Path(run_dir)
    dist.init_process_group("gloo", init_method=f"file://{run_dir / 'store'}", rank=rank,
                            world_size=world)
    try:
        dp = init_data_parallel("cpu")
        assert (dp.rank, dp.world) == (rank, world)
        inp = torch.load(run_dir / "inputs.pt", weights_only=False)
        torch.save(CASES[case](dp, inp), run_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
