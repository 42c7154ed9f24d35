"""Phase 2 (LDR resampling, the twin DRS discriminator) for Colored-MNIST: the JAX package's
train_mimicry_color_mnist_phase2.py surface plus --device (cli/mnist_scripts.py)."""
from diagan_tpu_torch.cli.mnist_scripts import phase2


def main(argv=None):
    return phase2("color_mnist", "./dataset/colour_mnist", "colour_mnist", argv)


if __name__ == "__main__":
    main()
