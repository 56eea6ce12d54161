"""Seeded STAGE-PURE violations in the port's terms (never imported):
engine/cuda.py's device surface is torch, the kernel module KN and the
engine's transfer and state helpers."""
import numpy as np
import torch

from ..ops import kernels as KN


class FakeEngine:
    def _stage_widgets(self, store, resolved, st):
        dev = self._h2d(np.zeros(4))             # STAGE-PURE: upload
        self._resident_state(store, "cnt", 4)    # STAGE-PURE: device state
        return {"staged": dev}

    def _stage_gadgets(self, store, resolved, st):
        return torch.zeros(4)                    # STAGE-PURE: torch in stage

    def _stage_sums(self, store, resolved, st):
        return KN.segment_sum(None, None, 4)     # STAGE-PURE: kernel launch

    def _stage_counter_rows(self, store, resolved, st):
        staged = [(np.arange(4),)]
        return {"v_s": self._stacked(staged, 0, 0, 4)}   # clean: staging
        #                                                  is the stage's job

    def _dispatch_widgets(self, store, plan, st):
        stack = np.stack([plan["staged"]])       # STAGE-PURE: heavy staging
        combined = self._combine_groups(         # STAGE-PURE: stage helper
            [stack], None, None)
        return combined

    def _dispatch_clean(self, store, plan, st):
        return self._h2d(plan["staged"])         # clean: device work is
        #                                          dispatch's job
