"""Plain PyTorch and NumPy references of the timed paths.

They import nothing of the program: each works out again, from the
inputs and seeded weights the benchmark hands to both sides, what the
program computes, so that its outputs can be judged.
"""
