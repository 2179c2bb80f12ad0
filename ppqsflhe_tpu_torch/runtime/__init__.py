from .native import NativeSerde, build_native, native_server_binary  # noqa: F401
