"""Host code of the PyTorch port in C++: the data library
(``wavedm_data.cc``, JPEG/PNG decode and the training crop stream), built
with the host compiler by ``build.py``."""
