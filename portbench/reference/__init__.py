"""Plain PyTorch references, one module per architecture, named by a
configuration's ``reference`` key.  They import nothing of the program."""
