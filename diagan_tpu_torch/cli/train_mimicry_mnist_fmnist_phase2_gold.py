"""The GOLD baseline's phase 2 for MNIST-FMNIST: the JAX package's
train_mimicry_mnist_fmnist_phase2_gold.py surface plus --device (cli/mnist_scripts.py)."""
from diagan_tpu_torch.cli.mnist_scripts import phase2_gold


def main(argv=None):
    return phase2_gold("mnist_fmnist", "./dataset/mnist_fmnist", "mnist_fmnist", argv)


if __name__ == "__main__":
    main()
