"""Native (C++) graph IO, a copy of ``force2vec_tpu/native/graphio.cpp``.
Built with g++ at first use by ``graphs/native.py``, into ``build/``."""
