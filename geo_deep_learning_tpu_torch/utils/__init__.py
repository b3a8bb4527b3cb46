"""Host and tensor utilities: CRS transforms, raster alignment and
statistics, tensor normalization, and the checkpoint-loading shim."""
