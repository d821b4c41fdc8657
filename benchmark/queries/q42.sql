SELECT d_year, i_category_id, i_category, SUM(ss_ext_sales_price) AS total
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id = 1 AND d_moy = 11 AND d_year = 2000
GROUP BY d_year, i_category_id, i_category
ORDER BY total DESC, d_year, i_category_id, i_category
LIMIT 100
