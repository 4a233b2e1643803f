"""Run configuration (a copy of ``msha_gnn_tpu/utils/config.py::TrainConfig``).

The fields and defaults are the JAX package's, except ``data_dir``, which
defaults to ``anonymous_data`` under the working directory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    model: str = "msha"          # msha | ablation1 | ablation2 | ablation3 |
                                 # gat | gcn | sage | hgane
    year: str = "2015"
    data_dir: str = "anonymous_data"
    epochs: int = 5
    lr: float = 1e-3
    weight_decay: float = 5e-4
    batch_size: int = 64
    in_features: int = 128
    out_features: int = 64       # hidden per head
    n_heads: int = 2
    dropout: float = 0.5
    seed: int = 42
    train_fraction: float = 0.9
    years: str = ""              # comma list -> joint multi-year training
    top_k: int = 100
    log_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None

    def model_flags(self):
        """Map a model preset name to MSHA-family flags."""
        return {
            "msha": dict(use_intra=True, joint_softmax=True, use_out_att=True),
            "ours": dict(use_intra=True, joint_softmax=True, use_out_att=True),
            "ablation1": dict(use_intra=True, joint_softmax=True,
                              use_out_att=False, n_heads=1),
            "ablation2": dict(use_intra=True, joint_softmax=False,
                              use_out_att=True),
            "ablation3": dict(use_intra=False, joint_softmax=True,
                              use_out_att=True),
        }[self.model]
