"""MNIST-FMNIST bias-probe classifier: the JAX package's
train_mnist_fmnist_feature.py surface plus --device (cli/mnist_scripts.py
bias_probe): SimpleConvNet on the mixed labels of a balanced build from
./dataset/mnist_fmnist, checkpoints under
./exp_results/mnist-fmnist-convnet-{num_data}-seed{seed}/."""
from diagan_tpu_torch.cli.mnist_scripts import bias_probe


def main(argv=None):
    return bias_probe("mnist_fmnist", "./dataset/mnist_fmnist", "mnist-fmnist-convnet", argv)


if __name__ == "__main__":
    main()
