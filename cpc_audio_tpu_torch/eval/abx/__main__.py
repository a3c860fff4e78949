"""``python -m cpc_audio_tpu_torch.eval.abx``: the ABX CLI under the
reference's entry name (``python cpc/eval/ABX.py``)."""

import sys

from ..abx_cli import main

if __name__ == "__main__":
    sys.exit(main())
