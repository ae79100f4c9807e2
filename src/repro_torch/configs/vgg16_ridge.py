"""The paper's own workload: VGG16-FC2 features → ridge → fMRI targets.

Port of ``repro/configs/vgg16_ridge.py``.  This is not a transformer
config — it is the brain-encoding workload of the paper (§2.2): feature
dimension p = 4 TRs × 4096 FC2 units = 16384, time samples n = 69,202,
targets t per resolution (Table 1).  Benchmarks and the encoding launcher
parameterise from here.
"""
import dataclasses

from repro_torch.core.complexity import PAPER_WORKLOADS, RidgeWorkload
from repro_torch.core.ridge import PAPER_LAMBDA_GRID


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    name: str
    workload: RidgeWorkload
    lambdas: tuple = PAPER_LAMBDA_GRID
    n_folds: int = 5
    test_frac: float = 0.1        # paper: 90/10 random split


RESOLUTIONS = {
    res: EncodingConfig(name=f"vgg16-ridge-{res}", workload=w)
    for res, w in PAPER_WORKLOADS.items()
}

CONFIG = RESOLUTIONS["whole_brain_bmor"]
