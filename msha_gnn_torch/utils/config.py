"""Run configurations (a copy of ``msha_gnn_tpu/utils/config.py``):
``TrainConfig`` (flow classification), ``LLPConfig`` (KD link prediction,
``cli llp``) and ``SGAEConfig`` (autoencoder pretrain and GraphSAGE
fine-tune, ``cli sgae``).

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


@dataclasses.dataclass
class LLPConfig:
    """KD link-prediction pipeline (the reference's ``LLP.py`` defaults)."""

    year: str = "2015"
    data_dir: str = "anonymous_data"
    num_layers: int = 2
    hidden_channels: int = 32
    dropout: float = 0.5
    lr: float = 5e-3
    epochs: int = 10
    eval_steps: int = 5          # validate every k epochs
    predictor: str = "mlp"       # mlp | inner
    patience: int = 100          # stop after k evaluations without a gain
    metric: str = "hits@20"      # auc | hits@20 | hits@50 (early stopping)
    val_fraction: float = 0.0    # a validation split of the train records
    use_valedges_as_input: bool = False  # the val edges join the teacher's
                                 # graph (with a val split only: the teacher
                                 # then sees the train edges, +val with this)
    kd_rank: float = 0.0         # weight of the margin-rank KD term
    final_linear: bool = True    # False: the reference's shipped predictor
                                 # (no last linear, a [B, hidden] output)
    eval_mode: str = "link"      # link (AUC / Hits@K against sampled
                                 # recipient negatives) | multiclass (the
                                 # reference's test(): the predictor's
                                 # [B, hidden] output scored as recipient
                                 # classes; final_linear=False and
                                 # hidden_channels == n_dst)
    true_label: float = 10.0
    kd_f: float = 0.1
    kd_p: float = 100.0
    margin: float = 0.1
    rw_step: int = 3             # nearby-node sampling repetitions
    ns_rate: int = 1             # negatives per positive
    hops: int = 2                # random-walk length
    ps_method: str = "nb"        # positive sampling: rw | nb
    ps_samples: int = 0          # anchors an epoch for sampled KD-only
                                 # positive pairs (0 = off)
    batch_size: int = 4096
    seed: int = 42
    teacher_heads: int = 2
    log_path: Optional[str] = None


@dataclasses.dataclass
class SGAEConfig:
    """GraphSAGE driver (the reference's ``SGAE.py`` defaults) with the
    autoencoder pretrain."""

    year: str = "2015"
    data_dir: str = "anonymous_data"
    epochs: int = 10
    lr: float = 1e-3
    weight_decay: float = 5e-4
    batch_size: int = 512
    in_features: int = 32
    dropout: float = 0.5
    seed: int = 42
    pretrain_epochs: int = 0     # the embedding pretrain's epochs
    years: str = ""              # comma list -> temporal multi-year pretrain
    log_path: Optional[str] = None
