from dustraytracer.diff.fd import fd_grad, check_grads_vs_fd

__all__ = ["fd_grad", "check_grads_vs_fd"]
