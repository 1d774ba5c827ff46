"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), against which the
roofline shares are stated: NVIDIA's data sheet for the memory bandwidth
and the boost clock, the CUDA C++ Programming Guide's arithmetic
throughput table (compute capability 9.0) for 32-bit integer
multiply-adds. The SM count is read from the card."""

SM_CLOCK_MHZ = 1980.0
HBM_BYTES_PER_S = 3.35e12
