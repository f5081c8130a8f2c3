"""The reduced dry-run matrix on a fake 2×2×2 world (the multi-pod mesh's
axes, ``("pod", "data", "model")``): ``launch.dryrun.run_cell`` for the
ten reduced architectures' decode steps, and the train step of one
architecture per mechanism (``TRAIN_ON_3D``), every cell ``ok``.

Apart from ``test_torch_dryrun.py`` so that the two matrices run on two
test workers: DTensor's planning on a 3-D mesh costs most of this file's
time on the CPU.
"""

import pytest

from repro_torch.configs import ARCH_IDS
from test_torch_dryrun import reduced_cells


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_matrix_on_a_fake_2x2x2_world(arch):
    reduced_cells(arch, (2, 2, 2))
