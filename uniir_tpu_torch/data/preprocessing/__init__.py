"""The offline M-BEIR construction: the port's copy of uniir_tpu/data/preprocessing/
(ten raw-dataset converters, the union generator), with the image pass of
`io_utils` run without Pillow (module docstring there) and a `--device`
flag on each converter with an image pass."""
