"""CAE reconstruction-error training of an Inclusive-GAN run's G: the JAX
package's train_cae_inclusive.py, which is train_cae.py itself (the
Inclusive G is the same DCGAN; DRS only where a netD_drs checkpoint
exists). See cli/train_cae.py."""
from diagan_tpu_torch.cli.train_cae import main

if __name__ == "__main__":
    main()
