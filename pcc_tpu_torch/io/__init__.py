from pcc_tpu_torch.io.ply import (read_point_cloud, read_point_cloud_attr, read_point_cloud_normals,
                                  read_point_clouds, save_point_cloud)

__all__ = ["read_point_cloud", "read_point_cloud_attr", "read_point_cloud_normals",
           "read_point_clouds", "save_point_cloud"]
