"""Plain PyTorch reference of the solved problem; imports nothing of the
program under test."""
