"""Receiver operations of the port: host constants, plain versions and CUDA kernel wrappers."""
