"""Sliding-window inference and IoU metrics."""
