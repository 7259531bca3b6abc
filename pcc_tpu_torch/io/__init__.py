from pcc_tpu_torch.io.ply import read_point_cloud, save_point_cloud

__all__ = ["read_point_cloud", "save_point_cloud"]
