// What the emulation's translation units share (harness.cpp).
#pragma once
#include <cstddef>
#include <functional>

// Runs `body` as every block of a grid in turn, each block's `threads`
// (a multiple of 32, at most 384) as std::threads with their warps'
// barriers; `smem` (the block's shared memory, `bytes`) is filled with NaN
// patterns before each block, so a read before a write shows. Returns
// false if a thread ended with cp.async copies or wgmma products it never
// waited for, or a barrier with copies that never landed.
bool run_grid(int grid, const std::function<void()>& body, void* smem,
              size_t bytes, int threads = 256);
