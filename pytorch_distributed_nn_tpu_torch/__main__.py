import sys

from pytorch_distributed_nn_tpu_torch.cli import main

sys.exit(main())
