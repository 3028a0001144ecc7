"""The benchmark's plain reference (`gaussian`): plain PyTorch, no import of
the program under test or of JAX."""
