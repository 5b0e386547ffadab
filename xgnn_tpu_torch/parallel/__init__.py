"""Multi-card training: one process a card on ``torch.distributed``."""
