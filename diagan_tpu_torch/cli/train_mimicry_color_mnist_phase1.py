"""Phase 1 (logits recorded in train mode) for Colored-MNIST: the JAX package's
train_mimicry_color_mnist_phase1.py surface plus --device (cli/mnist_scripts.py)."""
from diagan_tpu_torch.cli.mnist_scripts import phase1


def main(argv=None):
    return phase1("color_mnist", "./dataset/colour_mnist", "colour_mnist", argv)


if __name__ == "__main__":
    main()
