import sys

from deepcv_tpu_torch.cli import main

sys.exit(main())
