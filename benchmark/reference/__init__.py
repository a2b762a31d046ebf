"""The plain reference: the discrete equations of each configuration in
plain PyTorch, independent of the program under test (it imports nothing
of it and takes none of its tables)."""
