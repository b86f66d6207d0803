"""The benchmark's plain reference of the wavelet WaveDM.

Plain PyTorch and NumPy in float32: the Haar packet DWT/IWT
(``wavelet.py``), the diffusion UNet (``unet.py``) and the HFRM
(``hfrm.py``) with the port's ``state_dict`` names, the tiled DDIM chain
(``sampler.py``) and the stage-2 step: the epsilon loss, Adam and the EMA
(``train.py``).  ``precision.py`` holds the one switch through which every
convolution, linear layer and matmul runs, so the same code gives the
lower-precision control.

Nothing here imports the program (``wavedm_tpu_torch``), the JAX package
or JAX: it is written from the published model and the repository's
configuration files, and it takes only the inputs, weights and noise the
benchmark made.
"""
