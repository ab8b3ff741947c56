"""The benchmark's plain reference: Force2Vec's iterations in plain
PyTorch, independent of the program under test (``force2vec.py``)."""
