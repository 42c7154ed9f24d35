"""The GOLD baseline's phase 2 for Colored-MNIST: the JAX package's
train_mimicry_color_mnist_phase2_gold.py surface plus --device (cli/mnist_scripts.py)."""
from diagan_tpu_torch.cli.mnist_scripts import phase2_gold


def main(argv=None):
    return phase2_gold("color_mnist", "./dataset/colour_mnist", "colour_mnist", argv)


if __name__ == "__main__":
    main()
