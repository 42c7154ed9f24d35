"""A whole run with the timed path broken underneath reads `correct` false,
once for each fault a cell can have: a step that leaves its state
unchanged; half of the batch left out, the mean taken over the rest; the
main D given uniform rows and the twin weighted ones; an answer altered
where it is made (a served image; the accept decision).
The cells run on one card, so no exchange between cards can be left out."""
import pytest
import torch

from benchmark.tests.helpers import run_cell


def _half(loss):
    def half(*preds, **kw):
        return loss(*(p[:len(p) // 2] if isinstance(p, torch.Tensor) else p for p in preds), **kw)
    return half


def sg2_unchanged(mp):
    from diagan_tpu_torch.train import stylegan2_trainer as t

    class Still(torch.optim.Adam):
        def step(self, closure=None):
            return None

    mp.setattr(t, "reg_ratio_adam", lambda params, lr, every: Still(params, lr=lr))


def sg2_half(mp):
    from diagan_tpu_torch.train import stylegan2_trainer as t
    mp.setattr(t, "d_logistic_loss", _half(t.d_logistic_loss))
    mp.setattr(t, "g_nonsaturating_loss", _half(t.g_nonsaturating_loss))


def sg2_swapped_draws(mp):
    from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer
    draw_real = StyleGAN2Trainer.draw_real
    mp.setattr(StyleGAN2Trainer, "draw_real", lambda self, weighted: draw_real(self, not weighted))


def drs_altered(mp):
    from diagan_tpu_torch.eval import drs
    to_uint8 = drs.to_uint8

    def altered(images):
        out = to_uint8(images)
        out[:, 0, 0, 0] += 1
        return out

    mp.setattr(drs, "to_uint8", altered)


def drs_accept_all(mp):
    from diagan_tpu_torch.eval.drs import DRS
    mp.setattr(DRS, "_accept_device", lambda self, ldr, u, m, eps=1e-6: torch.ones_like(u,
                                                                                     dtype=bool))


@pytest.mark.parametrize("cell,fault", [
    ("sg2_256.p2_train", sg2_unchanged), ("sg2_256.p2_train", sg2_half),
    ("sg2_256.p2_train", sg2_swapped_draws),
    ("sg2_256.drs", drs_altered), ("sg2_256.drs", drs_accept_all)])
def test_a_broken_timed_path_reads_incorrect(cell, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    correct, checks, _ = run_cell(cell, tmp_path, monkeypatch)
    assert not correct, checks
