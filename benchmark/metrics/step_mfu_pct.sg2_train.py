"""The StyleGAN2 training window's FLOPs (the reference's count of each of
its steps) over the window's time and the fp32 peak."""
from benchmark.harness import counts

LAYER, MOVES = "train", "sg2_train_img_per_s"


def read(facts):
    return counts.mfu_pct(facts, counts.sg2_flops(facts))
