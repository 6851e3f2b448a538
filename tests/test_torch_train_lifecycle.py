"""The MTFI lifecycle in the port, as ``tests/test_mtfi_lifecycle.py`` runs
it in the JAX package: feature dumps from ``DINO+Point_MAE`` (stage 1),
FtoF distillation training on them (stage 2), and few-modal inference with
the trained checkpoint as ``fusion_module_path`` (stage 3), all on the CPU
with the small backbones, on a synthetic dataset on disk."""

import os

import numpy as np
import torch

from cmdiad_tpu_torch.config import Config, TrainConfig
from cmdiad_tpu_torch.data.synthetic import make_synthetic_dataset
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.runner import CMDIADRunner
from cmdiad_tpu_torch.train.checkpoint import flatten
from cmdiad_tpu_torch.train.distill import DistillTrainer, load_training_arrays

torch.set_num_threads(2)

SIZE = 64
DIM = 32
SMALL = dict(rgb_backbone_name="tiny", xyz_backbone_name="tiny", rgb_size=SIZE,
             xyz_size=SIZE, gt_size=SIZE, num_group=32, group_size=16, f_coreset=0.5,
             batch_size=2)


def test_mtfi_full_lifecycle(tmp_path):
    root = make_synthetic_dataset(str(tmp_path / "ds"), size=SIZE, n_train=5,
                                  n_test_good=2, n_test_bad=2)

    # stage 1: the dual method dumps the fusion features
    dump = str(tmp_path / "dumps")
    r1 = CMDIADRunner(Config(method_name="DINO+Point_MAE", dataset_path=root,
                             save_feature_for_fusion=True, save_path=dump, **SMALL),
                      device="cpu")
    r1.fit("widget")
    r1.evaluate("widget")

    # stage 2: FtoF distillation training on the dumps
    run = str(tmp_path / "run")
    tcfg = TrainConfig(train_method="HallucinationCrossModality", data_path=dump,
                       epochs=4, batch_size=4, warmup_epochs=1, blr=0.01, seed=0,
                       output_dir=run, save_every=2)
    assert load_training_arrays(tcfg, "train")["patch"].shape == (5, 3136, 2 * DIM)
    result = DistillTrainer(tcfg, feature_dim=DIM, device="cpu").train()
    assert result.history["train_loss"][-1] < result.history["train_loss"][0]
    assert sorted(os.listdir(run)) == ["checkpoint-1.npz", "checkpoint-3.npz",
                                       "metrics.jsonl"]

    # stage 3: few-modal inference with the trained net, from xyz alone
    cfg3 = Config(method_name="WithHallucination", main_modality="xyz", use_hn=True,
                  dataset_path=root, fusion_module_path=f"{run}/checkpoint-3.npz", **SMALL)
    r3 = CMDIADRunner(cfg3, device="cpu")
    served = flatten(names.to_flax(names.ftof_mlp(), r3.method.fusion.state_dict())["params"])
    trained = flatten(result.params)
    assert set(served) == set(trained)
    for k in trained:
        np.testing.assert_array_equal(served[k], trained[k])
    r3.fit("widget")
    metrics = r3.evaluate("widget")
    for k in ("image_rocauc", "pixel_rocauc", "au_pro"):
        assert 0.0 <= metrics[k] <= 1.0, metrics
    # the point-modality signal on synthetic dents survives MTFI
    assert metrics["pixel_rocauc"] > 0.5, metrics
