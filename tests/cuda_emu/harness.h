// What the emulation's translation units share (harness.cpp).
#pragma once
#include <cstddef>
#include <functional>

// Runs `body` as every block of a grid in turn, each block's 256 threads as
// std::threads with 8 warps' barriers; `smem` (the block's shared memory,
// `bytes`) is filled with NaN patterns before each block, so a read before
// a write shows. Returns false if a thread ended with cp.async copies it
// never waited for.
bool run_grid(int grid, const std::function<void()>& body, void* smem,
              size_t bytes);
