"""Phase 1 (logits recorded in train mode) for MNIST-FMNIST: the JAX package's
train_mimicry_mnist_fmnist_phase1.py surface plus --device (cli/mnist_scripts.py)."""
from diagan_tpu_torch.cli.mnist_scripts import phase1


def main(argv=None):
    return phase1("mnist_fmnist", "./dataset/mnist_fmnist", "mnist_fmnist", argv)


if __name__ == "__main__":
    main()
