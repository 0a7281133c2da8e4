"""The dev-loss plateau learning-rate state machine (counterpart of
mdd_tpu/train/plateau.py, the same state machine).

A pure-host reimplementation of the reference trainer's hand-rolled
scheduler (train_ctc.py:202-268): track the best dev loss within a
±end_adjust_acc band; after `patience` stagnant epochs, halve the LR,
restore the best model/optimizer snapshot, and stop training entirely
after `max_adjust_times` decays.  Separately track the best dev accuracy
snapshot, which is what gets saved at the end.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List


class PlateauAction(enum.Flag):
    NONE = 0
    SNAPSHOT_LOSS = enum.auto()   # dev loss improved: snapshot state
    SNAPSHOT_ACC = enum.auto()    # dev acc improved: snapshot best-acc state
    DECAY_AND_RESTORE = enum.auto()  # halve LR + restore loss snapshot
    STOP = enum.auto()


@dataclasses.dataclass
class PlateauScheduler:
    init_lr: float = 1e-3
    decay: float = 0.5
    end_adjust_acc: float = 2.0
    patience: int = 10
    max_adjust_times: int = 8

    learning_rate: float = dataclasses.field(init=False)
    loss_best: float = 1000.0
    loss_best_true: float = 1000.0
    adjust_rate_count: int = 0
    adjust_time: int = 0
    acc_best: float = 0.0
    stopped: bool = False

    def __post_init__(self):
        self.learning_rate = self.init_lr

    def step(self, dev_loss: float, dev_acc: float) -> PlateauAction:
        """Feed one epoch's dev metrics; returns the actions to take.

        Mirrors train_ctc.py:236-268, including the subtlety that an
        epoch inside the ±band that improves on loss_best_true also
        refreshes the snapshot.
        """
        action = PlateauAction.NONE

        if dev_loss < self.loss_best - self.end_adjust_acc:
            self.loss_best = dev_loss
            self.loss_best_true = dev_loss
            self.adjust_rate_count = 0
            action |= PlateauAction.SNAPSHOT_LOSS
        elif dev_loss < self.loss_best + self.end_adjust_acc:
            self.adjust_rate_count += 1
            if dev_loss < self.loss_best and dev_loss < self.loss_best_true:
                self.loss_best_true = dev_loss
                action |= PlateauAction.SNAPSHOT_LOSS
        else:
            self.adjust_rate_count = self.patience

        if dev_acc > self.acc_best:
            self.acc_best = dev_acc
            action |= PlateauAction.SNAPSHOT_ACC

        if self.adjust_rate_count >= self.patience:
            self.adjust_time += 1
            self.adjust_rate_count = 0
            if self.loss_best > self.loss_best_true:
                self.loss_best = self.loss_best_true
            self.learning_rate *= self.decay
            action |= PlateauAction.DECAY_AND_RESTORE

        if self.adjust_time >= self.max_adjust_times:
            self.stopped = True
            action |= PlateauAction.STOP
        return action
