"""E-step / M-step ops and the wrappers of the hand-written E-step
kernels (sparse and dense)."""
