"""Kernel wrappers, their plain versions, and the kernel build helper."""
