"""Training layer: jitted SGD steps, epoch-loop trainer, checkpointing.

Replaces the reference L5 (``CRF_Trainer`` / ``CRF_SGTrainer`` /
``CRF_GradBuilder`` — SURVEY.md §1).
"""
from asr_craft.train.trainer import (TrainConfig, Trainer, make_eval_step,
                                     make_optimizer, make_train_step)
from asr_craft.train.checkpoint import load_checkpoint, save_checkpoint
