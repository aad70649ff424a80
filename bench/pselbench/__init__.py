"""The benchmark of the PyTorch/CUDA port of parallel selected inversion.

The yardstick lives here, frozen against later changes to the port:
the matrix generators (:mod:`.matrices`), the structure analysis and the
operation counts (:mod:`.structure`), the dense-inverse reference and
the comparison (:mod:`.reference`), the percentile arithmetic
(:mod:`.stats`), the kernel classes and the trace reduction
(:mod:`.trace`) and the table of peaks (:mod:`.peaks`). :mod:`.cells`
finds configurations, cells, drivers and metric readers by name;
:mod:`.harness` runs one cell. Only :mod:`.harness` imports the port.
"""
