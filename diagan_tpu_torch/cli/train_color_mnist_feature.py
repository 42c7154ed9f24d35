"""Colored-MNIST bias-probe classifier: the JAX package's
train_color_mnist_feature.py surface plus --device (cli/mnist_scripts.py
bias_probe): SimpleConvNet on the bias labels of a balanced build from
./dataset/colour_mnist, checkpoints under
./exp_results/color-mnist-convnet-{num_data}-seed{seed}/."""
from diagan_tpu_torch.cli.mnist_scripts import bias_probe


def main(argv=None):
    return bias_probe("color_mnist", "./dataset/colour_mnist", "color-mnist-convnet", argv)


if __name__ == "__main__":
    main()
