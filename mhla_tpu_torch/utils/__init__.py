from .testing import assert_close, get_abs_err, get_err_ratio

__all__ = ["assert_close", "get_abs_err", "get_err_ratio"]
