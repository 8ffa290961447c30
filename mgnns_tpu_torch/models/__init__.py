"""The MGNNS fusion model and the text-only model (eval forward)."""
