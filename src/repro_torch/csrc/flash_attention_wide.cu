// The flash-attention templates of 192 and 256 (dh 129..256), forward
// and mma.sync backward: repro_flash_wide::forward / backward, which
// flash_attention.cu's entry points call. The kernels, their launches
// and their note are flash_attention.cu's; this file compiles them in a
// translation unit of their own, so that nvcc builds them beside the
// other templates (the build runs one nvcc a source, all at once) and
// the library builds in about the time the other templates take.
#define REPRO_FLASH_WIDE_UNIT
#include "flash_attention.cu"
