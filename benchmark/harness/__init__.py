"""The benchmark's general machinery: finding a cell's files, the chip
checks, tracing, the result line. Nothing here names a cell."""
