"""2× polyphase half-band oversampler coefficients (two 3-section allpass
branches). Port of the constants of `openwurli_tpu/ops/allpass.py`; the
allpass steps run inside the mono-chain kernel."""

import numpy as np

BRANCH_A_COEFFS = np.array(
    [0.036681502163648, 0.248030921580110, 0.643184620136480])
BRANCH_B_COEFFS = np.array(
    [0.110377634768680, 0.420399304190880, 0.854640112701920])
