"""Host code of the PyTorch port in C++: the data library
(``wavedm_data.cc``, the training crop stream, over its own JPEG and PNG
decoders ``jpeg_decode.cc`` and ``png_decode.cc``), built with the host
compiler by ``build.py``; it needs zlib alone."""
