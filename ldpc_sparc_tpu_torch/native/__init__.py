"""The native C++ BP oracle and tools (g++, built at first use)."""
