SELECT d_year, i_brand_id, i_brand, SUM(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id = 1 AND d_moy = 11 AND d_year = 2000
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, ext_price DESC, i_brand_id, i_brand
LIMIT 100
