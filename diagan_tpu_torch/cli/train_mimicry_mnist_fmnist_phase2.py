"""Phase 2 (LDR resampling, the twin DRS discriminator) for MNIST-FMNIST: the JAX package's
train_mimicry_mnist_fmnist_phase2.py surface plus --device (cli/mnist_scripts.py)."""
from diagan_tpu_torch.cli.mnist_scripts import phase2


def main(argv=None):
    return phase2("mnist_fmnist", "./dataset/mnist_fmnist", "mnist_fmnist", argv)


if __name__ == "__main__":
    main()
