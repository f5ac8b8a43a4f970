"""E-step / M-step ops and the fused sparse E-step kernel wrapper."""
